#!/usr/bin/env python3
"""Drives the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: its name and power limit; builds every Hopper kernel of the
     port from the sources in this checkout (nvcc, sm_90a, one process per
     source, all started together), and prints each source's and each
     tensor-core kernel's registers and spilled bytes; the libraries link
     torch's shared CUDA runtime (one libcudart in the process, checked);
  2. each kernel against its plain PyTorch version on the card, with q, k
     and v laid out as the step hands them over: simple_attention at the
     flagship's shape (B4 H16 S1024 D128, bf16 causal and not, f16, f32);
     causal_attention at the S=2048 rung's (B4 H8 S2048 D128, bf16, f16
     and f32); blocked_flash at the S=4096 rung's (B2 H8 S4096 D128: bf16
     and f16, causal and not and cross-attention Sq=1024 Skv=4096, and f32
     causal; its dq launch's delta too);
     qblock_attention at the GPT-3 Medium layout's (B2 H16 S4096 D64: bf16
     causal and not, f16, f32) and at the S=2048 rung's, non-causal (the
     non-causal middle tier); the library tier (flash_attention's op over
     blocked_flash.cu's kernels) at the Layer GPT-1.3B's shape (B4 H16 S1024
     D128, bf16 and f32, causal);
  3. a small model on the card (kernels) against the same model on the CPU
     (plain path): the loss and gradients agree;
  4. the paths, each through the port's setup() and step with random
     weights from a seed (PATHS): the GPT-1.3B flagship step (h2048, 24
     layers, 16 heads, vocab 50304, B4 S1024, bf16, remat "names", fused
     CE), then the reference bench's long-context rungs (bench.py:301-333),
     the 350M-class model (h1024, 24 layers, 8 heads of 128) at B4 S2048
     and at B2 S4096, and the same width at GPT-3 Medium's published head
     layout (16 heads of 64; Brown et al. 2020, Table 2.1) at B2 S4096,
     which the reference's gates send to qblock_attention. Every count is
     zeroed just before a path and read just after: each step must launch
     each kernel of the path's tier 24
     times and no other attention kernel, with dispatch only to that tier,
     a finite loss near ln(vocab) at step 0 and a loss that falls. Prints
     ms/step, tokens/s, MFU, peak memory and where the time goes;
  5. each kernel timed at its path's shape (the library tier's at the
     Layer GPT-1.3B's) beside its plain version, its
     bound on this card and one PyTorch library call that computes the same
     function (scaled_dot_product_attention, never used by the port), each
     as the median of 5 windows of CUDA events, with their spread;
  6. the attention autotuner: at each path's attention shape (bf16,
     causal) autotune.measure times every candidate's forward+backward (the
     median of 5 windows, and their spread); the winner must be the
     fastest Hopper kernel, plain attention ("xla") timed beside them but
     never the winner, every candidate finite (library_flash included); the
     persisted table, reloaded, must give the same
     winner, decide() too, and one flash_attention_maybe call must then
     launch the winner's kernel;
  7. the eager Paddle API (``import paddle_tpu_torch as paddle``), on a fresh
     empty autotune table: (a) the eager ``flash_attn`` op, causal bf16
     forward and ``.backward()`` on leaves from ``paddle.randn``, at each
     path's attention shape, where it must dispatch the path's tier once,
     launch each of its kernels once and no other, and agree with that
     tier's plain versions (phase 2's tolerances); (b) the GPT-1.3B forward
     and backward at full width and depth written in eager ops
     (``eager_gpt_loss``: indexing, mean/var/rsqrt LayerNorm, matmul,
     flash_attn, tanh-GELU, tied head with logsumexp and take_along_axis),
     on ``models/gpt_hybrid.init_params`` (seed 0), against the port's
     gpt_hybrid forward (remat off, plain CE) on the same params and
     batch: the step-0 loss in [10, 11.5] and within 1e-2 relative, the
     gradients of wte, block 0's qkv and block 23's fc2 weights within 5e-2
     of each leaf's scale, 24 launches each of simple_attention's forward
     and backward and of no other attention kernel; prints both
     forward+backward times (median of 5 windows and spread), the idle
     share of one profiled eager step and the peak memory;
  8. the Layer API and paddle.optimizer (``paddle.nn``, ``paddle.optimizer``,
     ``models/gpt.GPTForCausalLM``), on a fresh empty autotune table: (a) a
     small Layer GPT (h256, 2 layers, 4 heads of 64, vocab 512) at B2 S256
     on the card (the library tier) against the same state_dict on the CPU
     (plain attention), in f32 and after ``.bfloat16()``: the loss, every
     gradient, and one ``AdamW(multi_precision=True)`` step given the CPU's
     gradients; and the library op alone at [1, 8, Sq, Skv, 128], bf16 and
     f32, causal, (Sq, Skv) = (1024, 4096) and (4096, 1024), against its
     plain version, with dk and dv exactly zero past Sq; (b) the Layer
     GPT-1.3B (``GPTConfig.gpt3_1p3b()``: h2048, 24 layers, 16 heads of 128,
     vocab 50304, wpe 2048; seed 0, then ``.bfloat16()``) trained with
     ``AdamW(learning_rate=1e-4, multi_precision=True)`` at B4 S1024 for 6
     steps: every step dispatches scaled_dot_product_attention to the
     library op 24 times and launches its three kernels 24 times each and
     no other attention kernel; a finite step-0 loss and a last loss below
     it; prints ms/step (median of steps 2-6, spread), tokens/s, the
     forward+backward and optimizer split, the idle share of one profiled
     step with its top device rows, and the peak memory.
  9. serving (``inference.decode``, ``models/llama.py``): (a) tiny Llama
     (GQA: 4 heads, 2 kv) and tiny GPT in f32 from one state_dict each:
     DecodeSession's greedy ids on the card equal the CPU's plain path, and
     a ContinuousBatchingSession with overlapping lifetimes (the requests
     of tests/test_continuous_batching.py:31, 2 slots) equals isolated
     DecodeSession runs on the card, but where the isolated run's top-2
     logit margin is under 1e-4 of the logit scale (printed); (b)
     Llama-2-7B (``LlamaConfig.llama2_7b()``: vocab 32000, hidden 4096,
     ffn 11008, 32 layers, 32 heads of 128, 32 kv heads; Touvron et al.
     2023, Table 1), random weights from seed 0 built on the card, bf16,
     f32 caches: the no-cache scoring forward (eval) at B4 S1024 launches
     the library forward kernel 32 times a forward, counts
     nn.sdpa{library_flash} 32 times and launches no other attention
     kernel; DecodeSession(max_length=2048) on B8 prompts of 512 tokens
     (seed 0), 128 greedy tokens, whose first token equals the scoring
     forward's argmax (S512, same prompts) wherever its top-2 margin
     exceeds the printed bf16 bound, at a peak memory of one cache; and a
     ContinuousBatchingSession(max_slots=8, max_length=2048) on 24
     requests (prompts 64-1024, budgets 16-128, seed 0) submitted at once,
     each finishing once with its budget of in-vocab tokens, within 1 +
     the buckets used of programs. Prints the scoring forward's ms,
     prefill ms, decode ms/token (median, spread), tokens/s, the
     continuous session's tokens/s and time-to-first-token p50/p99 (its
     serving.* histogram), peak memory, the idle share of one profiled
     decode step and the step's bytes bound with its share.
 10. the MoE GPT (``models/gpt_hybrid`` with ``num_experts``), on a fresh
     empty autotune table: (a) a small config with 2 experts (h128, 2
     layers, 2 heads of 64, B4 S128, f32, remat "names") on the card
     (kernels) against the same params on the CPU (plain path): the loss
     and every gradient, the gate's and the experts' included, and
     ``build_accum_steps`` with k=2 then one apply gives the same
     parameters; (b) the full config of benchmarks/workloads/moe_ep.py at
     one device (vocab 50304, h1024, 24 layers, 8 heads of 128, 2 experts,
     B4 S1024, remat "names", bf16, zero1) through setup() and its step, 1
     warm-up and 3 timed steps, as a phase 4 path: 24 launches a step of
     each of simple_attention's kernels and no other attention kernel,
     dispatch only to "simple", the step-0 loss in [10, 11.5] and a loss
     that falls; prints ms/step, tokens/s, MFU with the FLOPs the dense
     dispatch issues (2 x the FFN) and with the top-1 count, the
     forward+backward/optimizer split, the idle share and the peak memory;
 11. BERT-base MLM under AMP O2 (``amp``, ``models/bert.py``), on a fresh
     empty autotune table: (a) a small BERT (h256, 2 layers, 4 heads of
     64, vocab 512) at B2 S128 in eval mode without a mask, f32, on the
     card (the library tier) and on the CPU (plain) from one state_dict:
     the logits, the loss and every gradient, and the library forward
     alone at BERT-base's attention (B32 H12 S128 D64 bf16, non-causal)
     against its plain version, timed beside it and beside one
     scaled_dot_product_attention call, with its bound; (b)
     ``BertForMaskedLM(BertConfig.base())`` as
     benchmarks/workloads/bert_mlm_amp.py runs it in full mode
     (AdamW(5e-5, multi_precision=True), decorate O2 bf16,
     GradScaler(2^10), B32 S128, 15 % of ids set to 0, labels = ids, fresh
     batches from RandomState(0), 10 steps): finite losses, the last below
     the first; bf16 params, f32 master weights and moments; found_inf
     false and the scale 2^10 on every step; every training step (dropout
     0.1) sends attention to the plain route and launches no attention
     kernel; then one eval scoring forward under auto_cast O2 (no mask)
     launches the library forward 12 times and no other attention kernel.
     Prints ms/step (median of steps 2-10, spread), sequences/s,
     tokens/s, the forward+backward/scaler+optimizer split, the idle share
     of one profiled step with its top device rows, and the peak memory.
 12. ResNet on CIFAR-10-shaped data (``io``, ``vision``; no Hopper kernel:
     convolutions, BatchNorm and pooling are torch's, as they are XLA's ops
     in the reference): (a) resnet18(num_classes=10) at B4 32x32 f32 on the
     card and on the CPU from one state_dict: a train-mode forward at B1
     (layer4's BatchNorms see one value a channel), then the logits, loss,
     every gradient, and the parameters and BatchNorm buffers after one
     Momentum(0.1, 0.9, weight_decay=5e-4) step; (b)
     benchmarks/workloads/resnet50_cifar10.py in full mode (resnet50, that
     Momentum, CrossEntropyLoss, Cifar10 or else FakeData(256) at
     3x32x32, DataLoader(batch_size=256, shuffle=True) iterated again when
     it runs out, its eager train_step): 3 warm-up and 20 timed steps,
     finite losses whose last is below the first; prints ms/step (each
     step timed alone on the host clock, median and spread), images/s, the
     data wait (the host's time in next()), forward+backward and optimizer
     ms (CUDA events), the idle share and top device rows of one profiled
     step, the peak memory, the FLOPs from the model's conv and linear
     shapes with the share of the f32 peak, then 1 + 5 steps under
     FLAGS_matmul_precision="default" (TF32 convolutions) beside them; (c)
     that loader, seeded, with 4 workers forked after CUDA is initialised:
     20 batches on the card equal bit for bit to the single-process
     loader's, both timed.
 13. training robustness (``hapi.Model.fit``, ``training``,
     ``distributed.checkpoint``/``watchdog``, ``observability.training``),
     on a fresh empty autotune table: (a) ``GPTConfig.tiny()`` through
     ``Model.fit`` (Momentum, f32, B2 S64) for 2 steps with a committed
     checkpoint, then a fresh Model, optimizer and loader resuming for 2
     more, on the card and on the CPU from one state_dict: the 4 losses and
     the parameters at phase 8a's f32 tolerance; (b) GPT-3 Medium's widths
     (Brown et al. 2020, Table 2.1: h1024, 24 layers, 16 heads of 64;
     vocab 50304, wpe 2048) as the Layer GPT, bf16, ``AdamW(1e-4,
     multi_precision=True)``, B4 S2048 from a seeded ``DataLoader(
     shuffle=True)`` over numpy token ids, with ``StepGuard(check_grads=
     True)``, a ``TrainStepWatchdog(600 s)``,
     ``FaultTolerantCheckpoint(every_n_steps=4)`` and
     ``observability.training.configure(flops_per_token=2.7395e9)``: run A
     trains 8 steps with committed checkpoints at steps 4 and 8; (c) run B
     trains 4 steps, a real SIGTERM makes the callback flush a committed
     checkpoint and stop fit, and a fresh Model, optimizer and loader
     resume for 4 more: the 8 losses and every parameter, master weight and
     moment bit-equal to run A's, each step dispatching
     scaled_dot_product_attention to the library op 24 times and launching
     each of its three kernels 24 times and no other attention kernel;
     (d) a loss that is NaN at one step: the parameters bit-equal across
     it, train.nan_steps ticks once, the next loss finite. Then the library
     kernels at B4 H16 S2048 D64 against their plain versions, timed beside
     them and SDPA, with their bounds. Prints ms/step (the host clock
     around each train_batch with its float(loss), median of steps 2-8,
     spread), tokens/s, MFU from the train.mfu gauge and from the clock,
     forward+backward and optimizer ms (CUDA events), StepGuard.pre_step's
     and the watchdog's cost a step, the checkpoint's bytes, save ms and
     GB/s, the resume's load ms, the idle share of one profiled step, the
     peak memory and the phase's seconds; a {"model_fit": {...}} line.
 14. jit, static and the predictor (``jit.to_static`` traced with
     ``make_fx`` and compiled by inductor, ``jit.save``/``load`` over
     ``torch.export``, ``inference.create_predictor``), on a fresh empty
     autotune table: (a) phase 8a's small Layer GPT, f32 and bf16,
     ``AdamW(multi_precision=True)``: 3 compiled steps against 3 eager
     steps on the card and on the CPU (losses; parameters within the
     larger of the leaf tolerance and twice the two eager runs' own
     distance, Adam's sign-sensitive elements held to its largest step),
     each compiled
     step launching each library kernel once a layer and no other, no
     eager fallback and no aten SDPA node; a value-dependent branch
     compiled to two specializations; compiled dropout differing call to
     call and repeating after ``paddle.seed``; the library ops' fake
     strides equal to the kernels' real ones; ``create_predictor`` with
     buckets [1, 2, 4] serving batches 1-7 from at most three graphs; (b)
     resnet50_cifar10.py's full mode as the workload writes it
     (``to_static(train_step, objs=[model, opt])``): its first step's loss
     and BatchNorm statistics against an eager step on the same batch
     from the same seed, the next two losses, then 20 steps: the first
     call's trace and compile seconds, ms/step (host clock, median and
     spread), images/s, the data wait, the idle share of one profiled
     step, the peak memory; (c) GPT-3 Medium's widths (phase 13's MEDIUM
     at 4 of its 24 layers, for the compile's time; GPT-2's N(0, 0.02)
     initialisation), bf16, ``AdamW(1e-4, multi_precision=True)``, B4
     S2048, the step compiled: 4 launches a step of each library kernel
     and no other attention kernel (nor in
     the profile), ``nn.sdpa{library_flash}`` ticking only while traced,
     no aten SDPA node, the step-0 loss in [10, 11.5] and equal to the
     eager forward's, a falling loss; prints the trace and compile
     seconds, ms/step, tokens/s, MFU, idle share and top rows, the peak
     memory, beside phase 13b's eager ms/step; (d) ``jit.save`` of that
     model's eval scoring forward with ``InputSpec([None, 2048],
     "int64")``, served by ``create_predictor(Config(path))`` at B1, B2
     and B4 from one program: logits against the eager forward's at the
     bf16 bound, 12 library forward launches a run; prints the file's
     size, the save and load seconds and ms a run; a {"jit": {...}} line.
     ``--phase14`` runs the build and this phase alone, for work on it;
 15. the rest of the eager API, on a fresh empty autotune table: (a) every
     ``paddle._C_ops`` binding (461, generated from the port's own yaml)
     resolves to a callable of the port; every function this slice adds
     (``ops/extra``, ``ops/vision_ops``, ``signal``, ``ops/compat``,
     ``geometric``, ``nn.functional``'s extended ops, ``nn.quant``) runs on
     one small input on the card and on the CPU, agreeing at 1e-5 of each
     output's scale (f32); the draws keep their support and moments; the AMP
     ops keep found_inf and the scale on the card; each explicit infermeta
     equals the real output's shape and dtype; ``weight_only_linear`` at
     Llama-2-7B's MLP width (x [8, 4096] bf16, int8 w [4096, 11008])
     against weight_dequantize + a bf16 matmul, each timed; the host time
     of one ``_C_ops`` call beside one eager op's; (b) GPT-1.3B's forward and
     backward written only in ``_C_ops`` bindings (``capi_gpt_loss``) on
     ``gpt_hybrid.init_params`` (seed 0) at B4 S1024 bf16: 24 launches each
     of simple_attention's two kernels and no other attention kernel, the
     step-0 loss in [10, 11.5] and within 1e-2 of ``eager_gpt_loss``'s, then
     3 steps of ``ops.extra.adamw_`` with f32 master weights and a falling
     loss; prints forward+backward and optimizer ms, ms/step, tokens/s, MFU
     (8.4863e9 FLOP/token), peak memory, the idle share of one profiled
     step, beside phases 7b and 8b; (c) the PTB large LSTM LM (Zaremba et
     al. 2014: vocab 10000, 2 layers of 1500, dropout 0.65, uniform +-0.04,
     SGD 1.0 with global-norm clipping at 10, B20, 35 steps unrolled): a
     small copy (vocab 50, hidden 32) on the card against the CPU (loss and
     gradients within 1e-5), then 10 steps on one repeated batch, the
     step-0 loss within 0.1 of ln(10000) and a falling loss; prints
     ms/step, tokens/s, the idle share and the recurrence's route (cuDNN);
     an {"eager_api": {...}} line. ``--phase15`` runs the build and this
     phase alone.
 16. collective parallelism over torch.distributed (see the phase 16
     section below); ``--phase16`` runs the build and it alone.
 17. tensor and sequence parallelism: (a) each tp/sp primitive (the
     column -> row linears, the vocab-parallel embedding, the parallel
     cross entropy, the sequence-parallel linears, the two ring collective
     matmuls, ring and Ulysses attention causal and not) at world 1 over
     NCCL against its plain form, f32 and bf16, output and gradients; (b)
     benchmarks/workloads/llama_tp_pp_sharding3.py's Llama-7B widths
     (vocab 32000, h4096, 32 heads of 128) at 16 of its 32 layers, B2
     S2048, bf16, remat "names", fused CE, zero1, sp, through setup() and
     the tp + sp step at world 1 over NCCL: its losses against the
     single-device step's (run just before), 16 launches a step of each of
     causal_attention's kernels and of no other, no host-staged
     collective; ms/step, tokens/s, MFU, the peak, the NCCL ms and idle
     share of one profiled step; then with collective_matmul; (c) two
     ranks at tp = 2 + sp over gloo on the one card through the launcher
     (2 layers): global losses within 2e-2 of the world-1 step's, 2
     launches a step of each causal_attention kernel at 16 local heads;
     ms/step, the collectives' host-clock ms, collective.host_staged. A
     {"tensor_parallel": {...}} line. ``--phase17`` runs the build and this
     phase alone;
 18. pipelines at the same Llama-7B widths, 4 layers in 2 stages, B4 S2048
     in 4 microbatches (the workload's B2 does not split into its 4): (a)
     gpt_hybrid.schedule_value_and_grad (the pipeline's stage, head and
     embedding backward over parallel.pp_schedule.run_schedule) in this
     process with 1F1B, ZBH1, the interleaved schedule (v = 2) and ZB-V,
     each schedule's loss and every
     gradient against the unpipelined single-device step within bf16's
     2e-2 of the scale, causal_attention's launches against the count the
     schedule and the recompute imply (``pp_expected_launches``), ms/step,
     peak_activations, peak memory and idle share; (b) gpt_hybrid at
     pp = 2 (4 layers) as two gloo ranks on the one card through the
     launcher with gpipe, 1f1b and zbh1: global losses within 2e-2 of the
     world-1 step's, each rank's launches, ms/step and pipeline hops. A
     {"pipeline": {...}} line. ``--phase18`` runs the build and this phase
     alone;
 19. expert parallelism and the semi-auto API over torch.distributed: (c)
     gpt_hybrid's ep branch at dp = 2 and (d) the manual-ep zero-bubble
     route (zbh1, dp2 x pp2) as 2 and 4 gloo ranks on the one card, both
     jobs started together at moe_ep's widths (h1024, 8 heads of 128,
     vocab 50304, B4 S1024) at 4 layers with 4 experts: global losses
     within 2e-2 of the world-1 step's, each rank's attention launches and
     all-to-alls against the counts written down before the run, the
     all-to-alls' bytes and host seconds, collective.host_staged; then at
     world 1 over NCCL: (a) global_scatter/global_gather, the ep
     all-to-all and the ep MoE FFN in f32 and bf16 against their plain
     forms; (b) moe_ep.py's full configuration (24 layers, E = 2, bf16,
     remat "names", ZeRO-1) through the ep branch against phase 10b's
     single-device losses, 24 launches a step of simple_attention's two
     kernels, 96 all-to-alls a step, ms/step, MFU, peak, NCCL ms and idle
     share; (e) the Layer GPT at GPT-3 Medium's widths (B4 S2048, bf16)
     through shard_tensor (Replicate) and to_static -> DistModel against
     its eager steps, 24 launches a step of each library kernel, ms/step
     beside phase 13b's; (f) auto_parallel.Engine(...).fit on it, the plan,
     the Planner's predicted ms/step beside phase 4's and 19e's measured,
     and auto_tuner.tune over the world-1 candidates with a trials file in
     a temporary directory. {"expert_parallel": {...}} and
     {"auto_parallel": {...}} lines. ``--phase19`` runs the build and this
     phase alone.
 20. the host runtime: (a) the native library (built with g++ from
     paddle_tpu_torch/native/src): collate of phase 12's ResNet-50 batch
     bit-equal to np.stack, the fused u8 HWC -> f32 CHW transform against
     its numpy form, TCPStore set/get/add/barrier from two client
     processes, the tracer's cost a span; (b) the parameter-server CTR loop
     at the widths of PaddleRec's Criteo DNN (26 slots of one id into
     1,000,001 ids, dim 9, 13 dense features, MLP 247-512-256-128-32-1,
     sigmoid CE): 2^14 Zipf(1.1) rows in a MultiSlot file loaded by
     InMemoryDataset's native parser, two servers started through fleet's
     PS flow, an Adam sparse table and the MLP in a dense table split over
     both, B512 for a pass of 32 steps on the card and an evaluation pass;
     the first 4 steps' losses and pushed gradients against the CPU's plain
     path on a second pair of tables, the second pass's loss below the
     first's, sparse_size equal to the distinct ids; examples/s, pull and
     push ms, the card step's ms, the idle share of a step profiled
     through the port's Profiler (its GEMM rows checked), the parsers' ms; (c) 2 gloo ranks under launch --elastic_store tcp://
     with their heartbeats in the store; (d) FleetExecutor: the Layer GPT
     at MEDIUM's widths (bf16, S2048) in two TaskNode stages (embedding +
     blocks 0-11; blocks 12-23 + norm + loss) over 4 microbatches of B1
     through source, compute and sink interceptors, against the unsplit
     forward, 24 lf_fwd launches a microbatch and no other attention
     kernel; (e) rpc_sync/rpc_async round trips to a second process (a
     small call, 4 MB), a callee's card matmul against the local call;
     (f) the Profiler (CPU and GPU targets, scheduler closed=1 ready=1
     record=2, two windows) over 8 training steps of (d)'s model:
     RecordEvent, op:: and kernel rows in the exported trace, 24 launches
     of each library kernel a recorded step and every kernel launch of the
     recorded steps with its device row; a Profiler without a scheduler
     over 2 steps with exactly 24 rows of each library kernel a step and
     no launch without a row (each lost launch is printed with its
     correlation id, its us after the recording's marker and the op that
     made it); summary(), the step's
     ms with the profiler on and off. A {"host_runtime": {...}} line.
     ``--phase20`` runs the build and this phase alone.
 21. the breadth slice: (a) Faster R-CNN R50-C4's detection head at COCO
     test size (an 800 x 1333 image: the C4 map [1, 1024, 50, 84], 15
     anchors a position, generate_proposals 6000 -> NMS 0.7 -> 1000,
     roi_align to 14 x 14 at 1/16, box_coder's decode of 1000 x 81 class
     boxes, the class-aware nms at 0.5 after a 0.05 threshold keeping 100,
     distribute_fpn_proposals over levels 2-5) on the card against the
     CPU's plain path: identical index sets, floats within 1e-5, roi_align's
     peak under 8 GB; each op's ms and nms's at 6000 boxes; (b) DCNv2's
     deformable 3x3 convolutions at ResNet-50's conv3-conv5 widths (B2, 800
     x 1333): forward and every gradient against the CPU within 1e-4,
     static.nn.deform_conv2d against vision.ops'; (c) Llama-2-7B's prefill
     written in incubate's fused functions on LlamaForCausalLM's weights
     (bf16, B1 S2048): its logits against the model's forward within 2e-2,
     32 lf_fwd launches a forward and no other attention kernel, a ragged
     batch of 4 through the variable-length attention with lengths against
     each sequence alone; (d) a fused_moe layer at Mixtral-8x7B's widths
     against its top-2 gathered form in f32; (e) Whisper's log-mel front
     end and MFCC at B32 x 30 s against the CPU within 1e-4, fft's round
     trip; (f) the Layer GPT at MEDIUM's widths pruned 2:4 by asp and
     trained by asp.decorate(LookAhead(AdamW)) for 6 steps with
     ModelAverage beside it: density 0.5 after each step, the sync at step
     5, falling losses, apply/restore bit-equal, 24 launches of each
     library kernel a step. A {"breadth": {...}} line. ``--phase21`` runs
     the build and this phase alone.
 22. The tail of the breadth: (a) QAT of the Layer GPT at MEDIUM's widths
     (bf16, AdamW multi_precision, B4 S2048), a channel-wise weight quanter
     and an abs-max activation quanter on all 96 block Linears: 4 steps
     with a falling loss from near ln(50304), 24 launches of each library
     kernel a step, then convert and eval forwards (24 lf_fwd, the scales
     frozen), ms/step beside the model without quanters; a 2-layer h256
     copy under QAT on the card against the CPU (losses, gradients, the
     learned scales); (b) PTQ of Llama-2-7B (bf16, 32 layers): 2
     calibration forwards at B1 S2048, convert in place to 224
     QuantedLinears, the converted forward on a held-out batch (32 lf_fwd,
     its loss within 1e-2 of the bf16 model's), ms and peak memory; (c)
     SECOND's voxel stem (SubmConv3D, BatchNorm, ReLU, strided Conv3D) at
     the KITTI grid [41, 1600, 1408] with 16,000 voxels, forward and
     backward, the submanifold sites kept, a [41, 200, 176] crop against
     the CPU; a GCN at ogbn-arxiv's size (169,343 nodes, 1,166,243 edges)
     through sparse.matmul, 3 Adam steps, step 0 against the CPU; (d)
     every distribution's log_prob and entropy on 2^16 parameter sets
     against the CPU, the moments of 2^20 draws; (e) run_check, a dlpack
     round trip, cpp_extension and a custom op on the card, onnx.export,
     version. A {"tail": {...}} line. ``--phase22`` runs the build and this
     phase alone.
The script sets FLAGS_matmul_precision to "highest", which the flag's
default gives a user: f32 products and convolutions run in f32.
Phases 2-6 keep the autotuner's table in a fresh temporary
PADDLE_TPU_CACHE_DIR, empty until phase 6, with FLAGS_attn_autotune at its
default: phases 2-5 (and 7, 8, 10 and 11, each on a table of its own) run
the configuration a user gets on a new checkout.
Prints {"serving": {...}}, {"moe_gpt": {...}}, {"bert": {...}},
{"resnet50": {...}}, {"model_fit": {...}}, {"jit": {...}},
{"eager_api": {...}}, {"distributed": {...}}, {"tensor_parallel": {...}},
{"pipeline": {...}}, {"expert_parallel": {...}}, {"auto_parallel": {...}},
{"host_runtime": {...}}, {"breadth": {...}} and {"tail": {...}} lines, the
script's seconds, the card line, then one {"kernels": [...]} line (each row with its design),
then as the last line
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
Importing this module runs nothing: ``eager_gpt_loss`` is the tests' too.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
# max |err| / max |plain|. f32: the same f32 arithmetic in another order.
# bf16: a few of bf16's 2^-8 steps of the output (the tensor-core backward
# also rounds P and dS to bf16 before its products). f16: the card tests'
# 1e-2, many of its 2^-11 steps; its narrower range rounds P under 6e-8 to 0.
TOL = {"bfloat16": 2e-2, "float16": 1e-2, "float32": 1e-4}

# (label, GPTConfig fields, B, S, dispatch tier, the kernels each layer
#  launches once a step, warm-up steps, timed steps)
PATHS = (
    ("flagship", dict(vocab_size=50304, hidden_size=2048, num_layers=24,
                      num_heads=16, max_seq_len=1024), 4, 1024, "simple",
     ("simple_attention_fwd", "simple_attention_bwd"), 2, 6),
    ("train_s2048", dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                         num_heads=8, max_seq_len=2048), 4, 2048,
     "causal_skip", ("causal_attention_fwd", "causal_attention_bwd"), 1, 3),
    ("train_s4096", dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                         num_heads=8, max_seq_len=4096), 2, 4096, "blocked",
     ("blocked_flash_fwd", "blocked_flash_bwd_dq", "blocked_flash_bwd_dkv"),
     1, 3),
    ("train_s4096_d64", dict(vocab_size=50304, hidden_size=1024,
                             num_layers=24, num_heads=16, max_seq_len=4096),
     2, 4096, "qblock", ("qblock_attention_fwd", "qblock_attention_bwd"),
     1, 3),
)

# (kernel, module stem (the reference's and the port's), line of its
#  pl.pallas_call in the reference, the
#  path whose shape it is held and timed at, its outputs, the products its
#  function needs, the [B, H, S, D] tensors it must move, the f32 [B, H, S]
#  row statistics it must move (lse, delta), the library call of the same
#  function)
# simple_attention2's kernels are simple_attention.cu's; that file's header
# says why.
CUDA_SOURCE = {"simple_attention2": "simple_attention",
               "flash_attention": "blocked_flash"}

# Every kernel runs its bf16 and f16 products on the tensor cores
# (csrc/attention_mma.cuh); f32 runs as f32 FMA on the CUDA cores. The rows
# below are bf16.
DESIGN = "tensor cores (mma.sync)"

KERNELS = (
    ("simple_attention_fwd", "simple_attention", 113, "flagship", ("o",),
     2, 4, 0, "fwd"),
    ("simple_attention_bwd", "simple_attention", 130, "flagship",
     ("dq", "dk", "dv"), 5, 7, 0, "bwd"),
    ("causal_attention_fwd", "causal_attention", 164, "train_s2048",
     ("o", "lse"), 2, 4, 1, "fwd"),
    ("causal_attention_bwd", "causal_attention", 184, "train_s2048",
     ("dq", "dk", "dv"), 5, 8, 1, "bwd"),
    ("blocked_flash_fwd", "blocked_flash", 210, "train_s4096", ("o", "lse"),
     2, 4, 1, "fwd"),
    ("blocked_flash_bwd_dq", "blocked_flash", 326, "train_s4096",
     ("dq", "delta"), 3, 6, 2, "bwd"),
    ("blocked_flash_bwd_dkv", "blocked_flash", 362, "train_s4096",
     ("dk", "dv"), 4, 6, 2, "bwd"),
    ("qblock_attention_fwd", "simple_attention2", 131, "train_s4096_d64",
     ("o",), 2, 4, 0, "fwd"),
    ("qblock_attention_bwd", "simple_attention2", 151, "train_s4096_d64",
     ("dq", "dk", "dv"), 5, 7, 0, "bwd"),
    # the library tier: flash_attention.py:53 reaches JAX's own Pallas TPU
    # flash kernel, whose pallas_calls for the forward, dk/dv and dq sit at
    # jax/experimental/pallas/ops/tpu/flash_attention.py:758, :1121, :1456
    ("library_flash_fwd", "flash_attention", 53, "layer_gpt", ("o", "lse"),
     2, 4, 1, "fwd"),
    ("library_flash_bwd_dq", "flash_attention", 53, "layer_gpt",
     ("dq", "delta"), 3, 6, 2, "bwd"),
    ("library_flash_bwd_dkv", "flash_attention", 53, "layer_gpt",
     ("dk", "dv"), 4, 6, 2, "bwd"),
)

# The Layer GPT-1.3B of phase 8b (GPTConfig.gpt3_1p3b() at B4 S1024): the
# shape at which the library tier's kernels are held and timed.
LAYER_GPT = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
                 num_heads=16, max_seq_len=2048)
LAYER_GPT_BATCH, LAYER_GPT_SEQ, LAYER_GPT_STEPS = 4, 1024, 6

# Phase 2's cases: (source stem, path of the shape, Sq (None: the path's S),
# dtype name, causal). The first bf16 causal case of each source at its
# path's shape gives the kernels' max_abs_err.
CHECKS = (
    ("simple_attention", "flagship", None, "bfloat16", True),
    ("simple_attention", "flagship", None, "bfloat16", False),
    ("simple_attention", "flagship", None, "float16", True),
    ("simple_attention", "flagship", None, "float32", True),
    ("causal_attention", "train_s2048", None, "bfloat16", True),
    ("causal_attention", "train_s2048", None, "float16", True),
    ("causal_attention", "train_s2048", None, "float32", True),
    ("blocked_flash", "train_s4096", None, "bfloat16", True),
    ("blocked_flash", "train_s4096", None, "bfloat16", False),
    ("blocked_flash", "train_s4096", 1024, "bfloat16", False),
    ("blocked_flash", "train_s4096", None, "float16", True),
    ("blocked_flash", "train_s4096", None, "float16", False),
    ("blocked_flash", "train_s4096", 1024, "float16", False),
    ("blocked_flash", "train_s4096", None, "float32", True),
    ("simple_attention2", "train_s4096_d64", None, "bfloat16", True),
    ("simple_attention2", "train_s4096_d64", None, "bfloat16", False),
    ("simple_attention2", "train_s4096_d64", None, "float16", True),
    ("simple_attention2", "train_s4096_d64", None, "float32", True),
    ("simple_attention2", "train_s2048", None, "bfloat16", False),
    ("flash_attention", "layer_gpt", None, "bfloat16", True),
    ("flash_attention", "layer_gpt", None, "float32", True),
)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def windows_ms(fn, reps, windows=5):
    """(median, max - min) over windows of the mean device time of fn()
    across reps calls (CUDA events), after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times)), max(times) - min(times)


def ptxas_rows(log):
    """(kernel, registers, spilled bytes) of each entry function in an
    nvcc -Xptxas -v log; kernel reads as name<dtype,D> from the mangled
    name (f float, __nv_bfloat16, __half), with ",lse" or ",recompute"
    after D for the dq launch's two forms."""
    import re
    rows, kernel, spill = [], None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"\d+([a-z_]+_kernel)I\d*(\w+?)Li(\d+)E(?:Lb(\d)E)?",
                          entry.group(1))
            form = {"1": ",lse", "0": ",recompute"}.get(m and m.group(4), "")
            kernel = (f"{m.group(1)}<{m.group(2)},{m.group(3)}{form}>" if m
                      else entry.group(1))
            spill = 0
        spilled = re.search(r"(\d+) bytes spill stores", line)
        if spilled:
            spill = int(spilled.group(1))
        used = re.search(r"Used (\d+) registers", line)
        if used and kernel is not None:
            rows.append((kernel, int(used.group(1)), spill))
            kernel = None
    return rows


def attention_shape(label):
    """B, H, S, D of a path's attention ("layer_gpt": phase 8b's,
    "model_fit": phase 13's)."""
    if label == "layer_gpt":
        fields, batch, seq = LAYER_GPT, LAYER_GPT_BATCH, LAYER_GPT_SEQ
    elif label == "model_fit":
        fields, batch, seq = MEDIUM, MEDIUM_BATCH, MEDIUM_SEQ
    else:
        _, fields, batch, seq, *_ = next(p for p in PATHS if p[0] == label)
    heads = fields["num_heads"]
    return batch, heads, seq, fields["hidden_size"] // heads


def bound(kernel):
    """Least time (ms) of a kernel at its path's shape (bf16) on this card
    and what sets it: its products of 2 * pairs * D operations over the
    bf16 peak, against its bytes (each input read once, each output
    written once) over HBM. Causal pairs (i, j <= i) only."""
    name, _, _, label, _, products, tensors, stats, _ = kernel
    b, h, s, d = attention_shape(label)
    ops_ms = products * 2 * b * h * s * (s + 1) // 2 * d \
        / PEAK_BF16_FLOPS * 1e3
    nbytes = tensors * b * h * s * d * 2 + stats * b * h * s * 4
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms > bytes_ms else "bytes")


def max_err(got, want):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return err, err / float(want.abs().max())


class Run:
    def __init__(self):
        self.failures = []

    def check(self, ok, what):
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)


def path_inputs(gen, dtype, torch, shape, sq=None):
    """q, k, v and dO as a model hands them to the kernels: [B, H, S, D]
    views into one [B, S, 3*H*D] qkv activation, or for cross-attention
    (sq given) q a view of a [B, Sq, H*D] activation and k, v views of one
    [B, S, 2*H*D]."""
    b, h, s, d = shape
    sq = sq or s

    def heads(x, n):
        return x.reshape(b, n, h, d).transpose(1, 2)

    def randn(*size):
        return torch.randn(*size, generator=gen, device="cuda").to(dtype)

    if sq == s:
        q, k, v = (heads(x, s) for x in randn(b, s, 3 * h * d).split(h * d, -1))
    else:
        q = heads(randn(b, sq, h * d), sq)
        k, v = (heads(x, s) for x in randn(b, s, 2 * h * d).split(h * d, -1))
    return q, k, v, heads(randn(b, sq, h * d), sq)


def kernel_calls(mods, source, q, k, v, do, scale, causal):
    """{kernel: (launch, plain version)} of one source's kernels on these
    inputs. A backward takes the forward kernel's own o and lse, as the
    step hands them over."""
    sa, ca, bf, sa2, fa = mods
    if source == "flash_attention":
        o, lse = fa.library_flash_fwd_cuda(q, k, v, scale, causal)
        res = (q, k, v, o, lse, do, scale, causal)
        _, delta = fa.library_flash_bwd_dq_cuda(*res)
        return {
            "library_flash_fwd": (
                lambda: fa.library_flash_fwd_cuda(q, k, v, scale, causal),
                lambda: fa.library_flash_reference(q, k, v, scale, causal)),
            "library_flash_bwd_dq": (
                lambda: fa.library_flash_bwd_dq_cuda(*res),
                lambda: (bf.lse_backward.dq_reference(*res),
                         (do.float() * o.float()).sum(-1))),
            "library_flash_bwd_dkv": (
                lambda: fa.library_flash_bwd_dkv_cuda(q, k, v, lse, delta,
                                                      do, scale, causal),
                lambda: bf.lse_backward.dkv_reference(*res))}
    if source == "simple_attention2":
        return {
            "qblock_attention_fwd": (
                lambda: sa2.qblock_attention_fwd_cuda(q, k, v, scale, causal),
                lambda: sa2.qblock_attention_reference(q, k, v, scale,
                                                       causal)),
            "qblock_attention_bwd": (
                lambda: sa2.qblock_attention_bwd_cuda(q, k, v, do, scale,
                                                      causal),
                lambda: sa2.qblock_attention_bwd_reference(q, k, v, do, scale,
                                                           causal))}
    if source == "simple_attention":
        return {
            "simple_attention_fwd": (
                lambda: sa.simple_attention_fwd_cuda(q, k, v, scale, causal),
                lambda: sa.simple_attention_reference(q, k, v, scale,
                                                      causal)),
            "simple_attention_bwd": (
                lambda: sa.simple_attention_bwd_cuda(q, k, v, do, scale,
                                                     causal),
                lambda: sa.simple_attention_bwd_reference(q, k, v, do, scale,
                                                          causal))}
    if source == "causal_attention":
        o, lse = ca.causal_attention_fwd_cuda(q, k, v, scale)
        res = (q, k, v, o, lse, do, scale)
        return {
            "causal_attention_fwd": (
                lambda: ca.causal_attention_fwd_cuda(q, k, v, scale),
                lambda: ca.causal_attention_reference(q, k, v, scale)),
            "causal_attention_bwd": (
                lambda: ca.causal_attention_bwd_cuda(*res),
                lambda: ca.causal_attention_bwd_reference(*res))}
    o, lse = bf.blocked_flash_fwd_cuda(q, k, v, scale, causal)
    res = (q, k, v, o, lse, do, scale, causal)
    _, delta = bf.blocked_flash_bwd_dq_cuda(*res)   # what dk/dv reads
    return {
        "blocked_flash_fwd": (
            lambda: bf.blocked_flash_fwd_cuda(q, k, v, scale, causal),
            lambda: bf.blocked_flash_reference(q, k, v, scale, causal)),
        "blocked_flash_bwd_dq": (
            lambda: bf.blocked_flash_bwd_dq_cuda(*res),
            lambda: (bf.blocked_flash_bwd_dq_reference(*res),
                     (do.float() * o.float()).sum(-1))),
        "blocked_flash_bwd_dkv": (
            lambda: bf.blocked_flash_bwd_dkv_cuda(q, k, v, lse, delta, do,
                                                  scale, causal),
            lambda: bf.blocked_flash_bwd_dkv_reference(*res))}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_kernels(run, mods, torch):
    """Phase 2: every kernel against its plain version on the card, each
    output (lse and delta included) within the dtype's tolerance of the
    plain output's scale (an lse or a delta, f32 row statistics, within the
    f32 one). Returns the worst absolute error of each kernel in its bf16
    causal case at its path's shape."""
    outputs = {k[0]: k[4] for k in KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for source, label, sq, dname, causal in CHECKS:
        dtype = getattr(torch, dname)
        shape = attention_shape(label)
        q, k, v, do = path_inputs(gen, dtype, torch, shape, sq)
        calls = kernel_calls(mods, source, q, k, v, do,
                             1.0 / math.sqrt(shape[-1]), causal)
        tag = (f"{dname} causal={causal} Sq={sq or shape[2]} Skv={shape[2]} "
               f"(B{shape[0]} H{shape[1]} D{shape[3]})")
        for name, (launch, plain) in calls.items():
            got = _tuple(launch())
            torch.cuda.synchronize()
            for out, g, w in zip(outputs[name], got, _tuple(plain())):
                tol = TOL["float32"] if out in ("lse", "delta") \
                    else TOL[dname]
                a, r = max_err(g, w)
                run.check(r <= tol, f"{name} {out} {tag}: max abs err {a:.3e}"
                          f" rel {r:.3e} (tolerance rel {tol})")
                if dname == "bfloat16" and causal and sq is None:
                    errs[name] = max(errs.get(name, 0.0), a)
    return errs


def check_small_model(run, TH, GPTConfig, torch):
    """Phase 3: the same tiny model, kernels on the card vs plain on CPU."""
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    pcfg = TH.ParallelConfig(remat=True, remat_policy="names",
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    cpu_params = TH.init_params(cfg, pcfg, gen, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 128)))
    out = {}
    for dev in ("cpu", "cuda"):
        params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in cpu_params.items()}
        leaves = TH._leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = (ids.to(dev), ids.to(dev))
        loss = TH.loss_fn(params, batch, cfg, pcfg)
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    torch.cuda.synchronize()
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(gg, gc))
    run.check(abs(lg - lc) <= 1e-5 * abs(lc) and worst <= 1e-4,
              f"tiny model f32, card vs cpu: loss {lg:.7f} vs {lc:.7f}, "
              f"worst grad leaf rel err {worst:.3e} (tolerance 1e-4)")


def drive(run, path, TH, GPTConfig, mods, fa, cost_model, torch, experts=0):
    """Phase 4 (and 10b, with ``experts``), one path: the training step
    through setup() and its step, with every count zeroed just before and
    read just after."""
    label, fields, batch, seq, tier, kernels, warm, timed_steps = path
    cfg = GPTConfig(**fields)
    pcfg = TH.ParallelConfig(remat=True, remat_policy="names", fused_ce=True,
                             param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16, moment_dtype=None,
                             num_experts=experts, zero1=True)
    params, opt_state, step = TH.setup(cfg, pcfg, seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for mod in mods:
        mod.reset_launch_counts()
    ticks0 = fa.dispatch_counts()
    losses = []
    for _ in range(warm):
        params, opt_state, loss = step(params, opt_state, (ids, ids))
        losses.append(float(loss))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    timed = []
    for _ in range(timed_steps):
        params, opt_state, loss = step(params, opt_state, (ids, ids))
        timed.append(loss)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: n for mod in mods for name, n in mod.LAUNCHES.items()}
    dispatch = fa.dispatch_counts(ticks0)
    losses += [float(x) for x in timed]

    steps = warm + timed_steps
    L = cfg.num_layers
    ms = start.elapsed_time(end) / timed_steps
    tok_s = batch * seq / (ms / 1e3)
    fpt = moe_flops_per_token(cfg, seq, experts, experts, cost_model) \
        if experts else cost_model.gpt_flops_per_token(cfg, seq)
    mfu = cost_model.mfu(tok_s, fpt, "H100")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: h{cfg.hidden_size}, {L} layers, {cfg.num_heads} heads "
          f"of {cfg.hidden_size // cfg.num_heads}, vocab {cfg.vocab_size}, "
          f"{experts} experts, B{batch} S{seq}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"{label}: {ms:.2f} ms/step (device events), "
          f"{wall / timed_steps * 1e3:.2f} ms/step (host clock), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} at {fpt:.4e} FLOP/token, "
          f"peak memory {peak_gb:.2f} GB", flush=True)
    extra = {}
    if experts:
        # what a top-1 router needs: the routed expert's FFN alone
        fpt1 = moe_flops_per_token(cfg, seq, 1, experts, cost_model)
        extra = {"flops_per_token": fpt, "flops_per_token_top1": fpt1,
                 "mfu_top1": cost_model.mfu(tok_s, fpt1, "H100")}
        print(f"{label}: MFU {mfu:.4f} with the FLOPs the dense dispatch "
              f"issues ({experts} x the FFN), {extra['mfu_top1']:.4f} with "
              f"the top-1 count ({fpt1:.4e} FLOP/token)", flush=True)
    ticks = ", ".join(f"{m}{{{v}}}: {n}" for (m, v), n in dispatch.items())
    print(f"{label}: launches {launches}, dispatch {ticks}", flush=True)
    run.check(all(math.isfinite(x) for x in losses),
              f"{label}: losses are finite")
    run.check(10.0 <= losses[0] <= 11.5,
              f"{label}: step-0 loss {losses[0]:.4f} near ln(50304) = 10.826")
    run.check(losses[-1] < losses[0], f"{label}: loss falls over the steps")
    run.check(launches == {n: L * steps if n in kernels else 0
                           for n in launches},
              f"{label}: {L} launches per step of each of {list(kernels)} "
              f"over {steps} steps, and no other attention kernel")
    # under "names" the recompute passes through dispatch again and gets
    # the saved outputs back without a launch: 2 ticks a layer, 1 launch
    run.check(set(dispatch) == {("attn.dispatch", tier)}
              and dispatch[("attn.dispatch", tier)] >= L * steps,
              f"{label}: every attention dispatched to {tier}, no fallback")
    run.check(0 < mfu < 1, f"{label}: MFU within (0, 1)")
    split = step_breakdown(TH, cfg, pcfg, params, opt_state, ids, torch)
    return {"launches": launches, "steps": steps, "ms_per_step": ms,
            "tokens_per_s": tok_s, "mfu": mfu, "peak_memory_gb": peak_gb,
            "step0_loss": losses[0], "last_loss": losses[-1],
            "losses": losses, **extra, **split}


def moe_flops_per_token(cfg, seq, experts_run, experts, cost_model):
    """Training FLOPs a token of the MoE GPT: the dense count with each
    layer's FFN (8h^2 of its 12h^2) run by ``experts_run`` experts (the
    dense dispatch runs all of them over every token; a top-1 router needs
    one), plus the gate's h x E product."""
    h, L = cfg.hidden_size, cfg.num_layers
    return cost_model.gpt_flops_per_token(cfg, seq) \
        + 6 * L * ((experts_run - 1) * 8 * h * h + h * experts)


def step_breakdown(TH, cfg, pcfg, params, opt_state, ids, torch):
    """Where one step's device time goes: forward+backward against the
    optimizer (CUDA events), and device time by kernel (torch.profiler)
    over one whole step, against that step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    leaves = TH._leaves(params)

    def fwd_bwd():
        for p in leaves:
            p.requires_grad_(True)
        loss = TH.loss_fn(params, (ids, ids), cfg, pcfg)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return grads

    grads = fwd_bwd()
    fb_ms = windows_ms(fwd_bwd, reps=2, windows=1)[0]
    opt_ms = windows_ms(lambda: TH.adamw_update(params, grads, opt_state),
                        reps=2, windows=1)[0]
    del grads
    step = TH.build_train_step(cfg, pcfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, (ids, ids))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"breakdown: forward+backward {fb_ms:.2f} ms, optimizer "
          f"{opt_ms:.2f} ms (device events); profiled step {wall_ms:.2f} ms "
          f"wall, {busy:.2f} ms kernel time, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}", flush=True)
    for key, ms, count in rows[:12]:
        print(f"  {ms:9.3f} ms {count:6d}x  {key[:100]}")
    return {"fwd_bwd_ms": fb_ms, "optimizer_ms": opt_ms,
            "profiled_step_ms": wall_ms, "kernel_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms)}


def time_kernels(mods, torch):
    """Phase 5: kernel, plain and library times of every kernel at its
    path's shape (bf16, causal), each {name: (median ms, spread ms)} over 5
    windows. The library call is one scaled_dot_product_attention(
    is_causal=True) forward, and its backward (dq, dk and dv together)
    beside each backward kernel."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    t = {}
    for source in dict.fromkeys(k[1] for k in KERNELS):
        label = next(k[3] for k in KERNELS if k[1] == source)
        shape = attention_shape(label)
        q, k, v, do = path_inputs(gen, torch.bfloat16, torch, shape)
        calls = kernel_calls(mods, source, q, k, v, do,
                             1.0 / math.sqrt(shape[-1]), True)
        for name, (launch, plain) in calls.items():
            t[name] = windows_ms(launch, reps=10)
            t[f"plain {name}"] = windows_ms(plain, reps=3)
        t[f"fwd {source}"] = windows_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            reps=10)
        ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        t[f"bwd {source}"] = windows_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True), reps=10)
    return t


# The forward kernel that each autotune winner launches.
WINNER_KERNEL = {"simple": "simple_attention_fwd",
                 "causal_skip": "causal_attention_fwd",
                 "qblock": "qblock_attention_fwd",
                 "library_flash": "library_flash_fwd"}


def check_autotune(run, mods, fa, at, torch):
    """Phase 6: the autotuner at each path's attention shape (bf16,
    causal), on the run's fresh table. Returns {path: {"winner",
    "timings_ms", "spread_ms"}}."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    tuned = {}
    for label in (p[0] for p in PATHS):
        b, h, s, d = attention_shape(label)
        bshd, dt = (b, s, h, d), torch.bfloat16
        tag = f"autotune {label} (B{b} S{s} H{h} D{d}, bf16 causal)"
        key = at._key(bshd, s, dt, True)
        run.check(at.lookup(bshd, s, dt, True) is None,
                  f"{tag}: no entry before the measurement")
        winner = at.measure(bshd, s, dt, True)
        ms = at._table[key]["timings_ms"]
        spread = at._table[key]["spread_ms"]
        tuned[label] = {"winner": winner, "timings_ms": ms,
                        "spread_ms": spread}
        kernels = {n: t for n, t in ms.items()
                   if t is not None and n != at.PLAIN}
        ranked = sorted(kernels, key=kernels.get)
        print(f"{tag}: forward+backward ms (median of 5 windows, spread) "
              + ", ".join(f"{n} {t} ({spread[n]})" for n, t in ms.items())
              + f"; winner {winner}, next kernel {ranked[1:2]}, plain "
              f"attention {'faster' if ms[at.PLAIN] < ms[winner] else 'slower'}"
              " than the winner", flush=True)
        run.check(winner == ranked[0],
                  f"{tag}: the winner is the fastest Hopper kernel")
        run.check(all(t is not None for t in ms.values())
                  and "library_flash" in ms,
                  f"{tag}: every tier (library_flash too) and plain "
                  "attention timed")
        with open(at._cache_path()) as f:
            disk = json.load(f).get(key, {}).get("winner")
        at._table = None
        again = at.lookup(bshd, s, dt, True)
        q = torch.empty(bshd, dtype=dt, device="cuda")
        decided = at.decide(q, q, True)
        run.check(disk == again == decided == winner,
                  f"{tag}: persisted {disk}, reloaded {again}, decided "
                  f"{decided}")
        q, k, v, _ = path_inputs(gen, dt, torch, (b, h, s, d))
        for mod in mods:
            mod.reset_launch_counts()
        ticks0 = fa.dispatch_counts()
        out = fa.flash_attention_maybe(*(x.transpose(1, 2) for x in (q, k, v)),
                                       causal=True)
        torch.cuda.synchronize()
        launched = {n: c for mod in mods for n, c in mod.LAUNCHES.items() if c}
        want = {"blocked_flash_fwd" if winner.startswith("blocked_")
                else WINNER_KERNEL[winner]: 1}
        run.check(fa.dispatch_counts(ticks0) == {("attn.dispatch", winner): 1}
                  and launched == want and out is not None,
                  f"{tag}: one flash_attention_maybe call dispatches "
                  f"{winner}, launches {launched}")
    return tuned


# ---------------------------------------------------------------- phase 7
# The plain versions of each tier's kernels, causal: o and (dq, dk, dv).
TIER_SOURCE = {"simple": "simple_attention", "causal_skip": "causal_attention",
               "blocked": "blocked_flash", "qblock": "simple_attention2"}


def plain_attention(mods, tier, q, k, v, do, scale):
    """o and (dq, dk, dv) of ``tier``'s plain forward and backward (causal,
    [B, H, S, D]), the backward from the plain forward's own o and lse."""
    sa, ca, bf, sa2, _ = mods
    if tier == "simple":
        return (sa.simple_attention_reference(q, k, v, scale, True),
                sa.simple_attention_bwd_reference(q, k, v, do, scale, True))
    if tier == "qblock":
        return (sa2.qblock_attention_reference(q, k, v, scale, True),
                sa2.qblock_attention_bwd_reference(q, k, v, do, scale, True))
    if tier == "causal_skip":
        o, lse = ca.causal_attention_reference(q, k, v, scale)
        return o, ca.causal_attention_bwd_reference(q, k, v, o, lse, do,
                                                    scale)
    o, lse = bf.blocked_flash_reference(q, k, v, scale, True)
    res = (q, k, v, o, lse, do, scale, True)
    return o, (bf.blocked_flash_bwd_dq_reference(*res),
               *bf.blocked_flash_bwd_dkv_reference(*res))


def check_eager_attention(run, paddle, mods, fa, torch):
    """Phase 7a: the eager flash_attn at each path's attention shape."""
    for label, _, _, _, tier, kernels, *_ in PATHS:
        b, h, s, d = attention_shape(label)
        tag = f"eager flash_attn [{b}, {s}, {h}, {d}] bf16 causal"
        paddle.seed(4)
        q, k, v = (paddle.randn([b, s, h, d], dtype="bfloat16")
                   for _ in range(3))
        for t in (q, k, v):
            t.stop_gradient = False
        for mod in mods:
            mod.reset_launch_counts()
        ticks0 = fa.dispatch_counts()
        out = paddle.ops.extra.flash_attn(q, k, v, causal=True)
        out.backward()
        torch.cuda.synchronize()
        launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
        dispatch = fa.dispatch_counts(ticks0)
        run.check(dispatch == {("attn.dispatch", tier): 1}
                  and launches == {n: int(n in kernels) for n in launches},
                  f"{tag}: dispatches {tier} once and launches each of "
                  f"{list(kernels)} once (launches {launches})")
        qt, kt, vt = (t._data.detach().transpose(1, 2) for t in (q, k, v))
        o, grads = plain_attention(mods, tier, qt, kt, vt,
                                   torch.ones_like(qt), 1.0 / math.sqrt(d))
        got = [out._data.transpose(1, 2)] + [t.grad._data.transpose(1, 2)
                                            for t in (q, k, v)]
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, (o, *grads)):
            a, r = max_err(g, w)
            run.check(r <= TOL["bfloat16"],
                      f"{tag}: {name} against {tier}'s plain version, max abs "
                      f"err {a:.3e} rel {r:.3e} (tolerance rel "
                      f"{TOL['bfloat16']})")


def eager_gpt_loss(paddle, params, ids, cfg):
    """The GPT causal-LM loss of models/gpt_hybrid.py written in the eager
    Paddle API of ``paddle`` (the port, or the reference package): the
    computation of gpt_hybrid's forward with remat off and the plain
    (unfused) cross-entropy, in the parameters' dtype. ``params`` is
    gpt_hybrid's tree of eager Tensors (blocks stacked [L, ...]), ``ids``
    an integer Tensor [B, S]; the labels are the ids themselves."""
    b, s = ids.shape
    h, nh = cfg.hidden_size, cfg.num_heads
    d = h // nh
    wte = params["wte"]

    def layer_norm(x, g, bias):
        # statistics in f32, cast back before the affine (gpt_hybrid)
        xf = x.astype("float32")
        mu = paddle.mean(xf, axis=-1, keepdim=True)
        var = paddle.var(xf, axis=-1, unbiased=False, keepdim=True)
        return ((xf - mu) * paddle.rsqrt(var + 1e-5)).astype(x.dtype) * g \
            + bias

    def heads(t):
        return t.reshape([b, s, nh, d])

    x = wte[ids] + params["wpe"][:s]
    names = sorted(params["blocks"])
    for lp in zip(*(paddle.unbind(params["blocks"][n], 0) for n in names)):
        lp = dict(zip(names, lp))
        hx = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        qkv = paddle.matmul(hx, lp["qkv_w"]) + lp["qkv_b"]
        attn = paddle.ops.extra.flash_attn(
            heads(qkv[:, :, :h]), heads(qkv[:, :, h:2 * h]),
            heads(qkv[:, :, 2 * h:]), causal=True).reshape([b, s, h])
        x = x + (paddle.matmul(attn, lp["proj_w"]) + lp["proj_b"])
        hx = layer_norm(x, lp["ln2_g"], lp["ln2_b"])
        f1 = paddle.matmul(hx, lp["fc1_w"]) + lp["fc1_b"]
        gelu = 0.5 * f1 * (1.0 + paddle.tanh(
            0.7978845608028654 * (f1 + 0.044715 * paddle.pow(f1, 3))))
        x = x + (paddle.matmul(gelu, lp["fc2_w"]) + lp["fc2_b"])
    x = layer_norm(x, params["lnf_g"], params["lnf_b"])
    logits = paddle.matmul(x, wte, transpose_y=True)[:, :-1]
    logits = logits.astype("float32")
    logz = paddle.logsumexp(logits, axis=-1)
    picked = paddle.take_along_axis(logits, paddle.unsqueeze(ids[:, 1:], -1),
                                    axis=-1)
    return paddle.mean(logz - paddle.squeeze(picked, -1))


def capi_gpt_loss(C, params, ids, cfg):
    """``eager_gpt_loss`` written only in the bindings of ``C``, a
    ``_C_ops`` module (the port's or the reference package's): embedding,
    layer_norm (its statistics in f32), matmul, flash_attn (causal),
    tanh-GELU, and the tied head's logsumexp and take_along_axis."""
    b, s = ids.shape
    h, nh = cfg.hidden_size, cfg.num_heads
    d = h // nh
    wte = params["wte"]

    def linear(x, w, bias):
        return C.add(C.matmul(x, w), bias)

    def heads(t, i):
        return C.reshape(C.slice(t, [2], [i * h], [(i + 1) * h]),
                         [b, s, nh, d])

    x = C.add(C.embedding(ids, wte), C.slice(params["wpe"], [0], [0], [s]))
    names = sorted(params["blocks"])
    for lp in zip(*(C.unbind(params["blocks"][n], 0) for n in names)):
        lp = dict(zip(names, lp))
        hx = C.layer_norm(x, [h], lp["ln1_g"], lp["ln1_b"], 1e-5)
        qkv = linear(hx, lp["qkv_w"], lp["qkv_b"])
        attn = C.reshape(C.flash_attn(heads(qkv, 0), heads(qkv, 1),
                                      heads(qkv, 2), causal=True), [b, s, h])
        x = C.add(x, linear(attn, lp["proj_w"], lp["proj_b"]))
        hx = C.layer_norm(x, [h], lp["ln2_g"], lp["ln2_b"], 1e-5)
        f1 = C.gelu(linear(hx, lp["fc1_w"], lp["fc1_b"]), True)
        x = C.add(x, linear(f1, lp["fc2_w"], lp["fc2_b"]))
    x = C.layer_norm(x, [h], params["lnf_g"], params["lnf_b"], 1e-5)
    logits = C.cast(C.slice(C.matmul(x, wte, False, True), [1], [0],
                            [s - 1]), "float32")
    logz = C.logsumexp(logits, -1)
    labels = C.unsqueeze(C.slice(ids, [1], [1], [s]), -1)
    picked = C.squeeze(C.take_along_axis(logits, labels, -1), -1)
    return C.mean(C.subtract(logz, picked))


def drive_eager_gpt(run, paddle, TH, GPTConfig, mods, fa, torch):
    """Phase 7b: the flagship's forward and backward in eager ops against
    gpt_hybrid's, with every count zeroed just before the eager run."""
    label, fields, batch, seq, tier, kernels, *_ = PATHS[0]
    cfg = GPTConfig(**fields)
    L = cfg.num_layers
    pcfg = TH.ParallelConfig(remat=False, fused_ce=False,
                             param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16)
    tparams = TH.init_params(cfg, pcfg,
                             torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    # trainable eager Tensors sharing gpt_hybrid's storage
    params = TH.eager_params_from_jax(tparams, device="cuda")
    leaves = [params["wte"], params["blocks"]["qkv_w"],
              params["blocks"]["fc2_w"]]
    ids_np = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              (batch, seq))
    ids = paddle.to_tensor(ids_np)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods:
        mod.reset_launch_counts()
    ticks0 = fa.dispatch_counts()
    loss = eager_gpt_loss(paddle, params, ids, cfg)
    loss.backward()
    torch.cuda.synchronize()
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    dispatch = fa.dispatch_counts(ticks0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eager_loss = float(loss)
    eager_grads = (leaves[0].grad._data, leaves[1].grad._data[0],
                   leaves[2].grad._data[L - 1])

    hp = {k: ({kk: vv.detach().requires_grad_(True) for kk, vv in v.items()}
              if isinstance(v, dict) else v.detach().requires_grad_(True))
          for k, v in tparams.items()}
    ids_t = torch.from_numpy(ids_np).cuda()

    def hybrid_fwd_bwd():
        hloss = TH.loss_fn(hp, (ids_t, ids_t), cfg, pcfg)
        return hloss, torch.autograd.grad(
            hloss, [hp["wte"], hp["blocks"]["qkv_w"], hp["blocks"]["fc2_w"]])

    hloss, (gw, gq, gf) = hybrid_fwd_bwd()
    hybrid_loss = float(hloss)
    print(f"eager gpt ({label}, bf16, remat off, plain CE): step-0 loss "
          f"{eager_loss:.6f} eager, {hybrid_loss:.6f} gpt_hybrid; launches "
          f"{launches}; dispatch {dispatch}; peak memory {peak_gb:.2f} GB",
          flush=True)
    run.check(10.0 <= eager_loss <= 11.5
              and abs(eager_loss - hybrid_loss) <= 1e-2 * abs(hybrid_loss),
              f"eager gpt: step-0 loss {eager_loss:.6f} in [10, 11.5] and "
              f"within 1e-2 relative of gpt_hybrid's {hybrid_loss:.6f}")
    for name, g, w in zip(("wte", "blocks.qkv_w[0]", f"blocks.fc2_w[{L - 1}]"),
                          eager_grads, (gw, gq[0], gf[L - 1])):
        a, r = max_err(g, w)
        run.check(r <= 5e-2, f"eager gpt: grad of {name} against gpt_hybrid's,"
                  f" max abs err {a:.3e}, {r:.3e} of the leaf's scale "
                  "(tolerance 5e-2)")
    run.check(launches == {n: L if n in kernels else 0 for n in launches}
              and dispatch == {("attn.dispatch", tier): L},
              f"eager gpt: {L} launches each of {list(kernels)}, no other "
              f"attention kernel, {L} dispatches to {tier}")
    del hloss, gw, gq, gf, eager_grads, loss

    every = [v for k, v in params.items() if k != "blocks"] \
        + list(params["blocks"].values())

    def eager_fwd_bwd():
        for t in every:
            t.clear_grad()
        eager_gpt_loss(paddle, params, ids, cfg).backward()

    eager_ms, eager_spread = windows_ms(eager_fwd_bwd, reps=1)
    hybrid_ms, hybrid_spread = windows_ms(hybrid_fwd_bwd, reps=1)

    # what eager dispatch costs the host: the forward's ops and the host
    # time that issuing them takes, beside gpt_hybrid's forward (each run
    # alone, after the other's tensors are freed, so that neither waits
    # for memory the other holds)
    from paddle_tpu_torch.observability.metrics import REGISTRY
    dispatches = REGISTRY.counter("eager.op_dispatches")

    def issue_ms(forward):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward()
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        del out
        return ms

    n0 = dispatches.value
    eager_issue_ms = issue_ms(lambda: eager_gpt_loss(paddle, params, ids, cfg))
    n_ops = int(dispatches.value - n0)
    hybrid_issue_ms = issue_ms(
        lambda: TH.loss_fn(hp, (ids_t, ids_t), cfg, pcfg))
    print(f"eager gpt: the forward issues {n_ops} eager ops in "
          f"{eager_issue_ms:.2f} ms of host time "
          f"({eager_issue_ms / n_ops * 1e3:.1f} us an op); gpt_hybrid's "
          f"forward {hybrid_issue_ms:.2f} ms", flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eager_fwd_bwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    idle = max(0.0, 1 - busy / wall_ms)
    for key, ms, count in rows[:12]:
        print(f"  {ms:9.3f} ms {count:6d}x  {key[:100]}")
    print(f"eager gpt: forward+backward {eager_ms:.2f} ms (spread "
          f"{eager_spread:.2f}) eager, {hybrid_ms:.2f} ms (spread "
          f"{hybrid_spread:.2f}) gpt_hybrid, ratio {eager_ms / hybrid_ms:.3f};"
          f" profiled eager step {wall_ms:.2f} ms wall, {busy:.2f} ms kernel "
          f"time, idle share {idle:.3f}", flush=True)
    return {"step0_loss": eager_loss, "gpt_hybrid_step0_loss": hybrid_loss,
            "fwd_bwd_ms": eager_ms, "fwd_bwd_ms_spread": eager_spread,
            "gpt_hybrid_fwd_bwd_ms": hybrid_ms,
            "gpt_hybrid_fwd_bwd_ms_spread": hybrid_spread,
            "profiled_ms": wall_ms, "kernel_ms": busy, "idle_share": idle,
            "forward_ops": n_ops, "forward_issue_ms": eager_issue_ms,
            "gpt_hybrid_forward_issue_ms": hybrid_issue_ms,
            "peak_memory_gb": peak_gb, "launches": launches}


# ---------------------------------------------------------------- phase 8
# The small Layer GPT of 8a: D=64, S=256 (the library gate's head dims and
# multiples of 128).
SMALL_LAYER_GPT = dict(vocab_size=512, hidden_size=256, num_layers=2,
                       num_heads=4, max_seq_len=256)
# (loss relative, gradient and parameter, each of its leaf's scale): f32 the
# same arithmetic in another order; bf16 a few of bf16's steps, where the
# card's kernels and the CPU's plain path round at other points.
LAYER_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 5e-2)}


def _leaf_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check_small_layer_gpt(run, paddle, GPTConfig, GPTForCausalLM, fa, mods,
                          torch):
    """Phase 8a: the small Layer GPT on the card (the library tier) against
    the CPU (plain attention), from one state_dict, in f32 and bf16."""
    cfg = GPTConfig(**SMALL_LAYER_GPT)
    ids = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 256))
    paddle.seed(0)
    paddle.set_device("cpu")
    state = {k: v.numpy() for k, v in GPTForCausalLM(cfg).state_dict()
             .items()}
    for dname, (loss_tol, leaf_tol) in LAYER_TOL.items():
        out = {}
        for dev in ("cpu", "gpu:0"):
            paddle.set_device(dev)
            model = GPTForCausalLM(cfg)
            model.set_state_dict(state)
            if dname == "bfloat16":
                model.bfloat16()
            for mod in mods:
                mod.reset_launch_counts()
            ticks0 = fa.dispatch_counts()
            t = paddle.to_tensor(ids)
            loss = model(t, t)
            loss.backward()
            launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
            dispatch = fa.dispatch_counts(ticks0)
            params = dict(model.named_parameters())
            out[dev] = (float(loss), {n: p.grad.numpy()
                                      for n, p in params.items()})
            # one AdamW step, every device from the CPU's gradients: Adam's
            # first step is lr * g / (|g| + eps), which turns round-off in
            # a gradient near zero (the k bias's is zero exactly) into a
            # whole step, so it is held on equal inputs
            for n, p in params.items():
                p.grad = paddle.to_tensor(out["cpu"][1][n]).astype(p.dtype)
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=model.parameters(),
                                         multi_precision=True)
            opt.step()
            out[dev] += ({n: p.numpy() for n, p in params.items()},)
        L = cfg.num_layers
        tag = f"layer gpt small ({dname}, B2 S256 D64)"
        run.check(launches == {n: L if n in fa.LAUNCHES else 0
                               for n in launches}
                  and dispatch == {("nn.sdpa", "library_flash"): L},
                  f"{tag}: {L} launches of each library kernel on the card "
                  f"and no other (launches {launches}, dispatch {dispatch})")
        (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["gpu:0"]
        grad_err = max(_leaf_err(gg[n], gc[n]) for n in gc)
        param_err = max(_leaf_err(pg[n], pc[n]) for n in pc)
        run.check(abs(lg - lc) <= loss_tol * abs(lc),
                  f"{tag}: loss {lg:.7f} card vs {lc:.7f} cpu (tolerance "
                  f"rel {loss_tol})")
        run.check(grad_err <= leaf_tol,
                  f"{tag}: worst gradient {grad_err:.3e} of its leaf's "
                  f"scale (tolerance {leaf_tol})")
        run.check(param_err <= leaf_tol,
                  f"{tag}: after one AdamW(multi_precision) step, worst "
                  f"parameter {param_err:.3e} of its scale (tolerance "
                  f"{leaf_tol})")
    paddle.set_device("gpu:0")


def check_library_cross(run, fa, torch):
    """Phase 8a: the library op alone, causal Sq != Skv, against autograd
    of its plain version; dk and dv exactly zero past Sq."""
    gen = torch.Generator(device="cuda").manual_seed(81)
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for sq, skv in ((1024, 4096), (4096, 1024)):
            def randn(s):
                return torch.randn(1, s, 8, 128, generator=gen,
                                   device="cuda").to(dtype)
            q, k, v, do = randn(sq), randn(skv), randn(skv), randn(sq)
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            got = fa.flash_attention(*leaves, causal=True)
            got = (got, *torch.autograd.grad(got, leaves, do))
            plain = [x.float().transpose(1, 2).requires_grad_(True)
                     for x in (q, k, v)]
            o, _ = fa.library_flash_reference(*plain, 128 ** -0.5, True)
            want = (o.transpose(1, 2),
                    *(g.transpose(1, 2) for g in torch.autograd.grad(
                        o, plain, do.float().transpose(1, 2))))
            torch.cuda.synchronize()
            tag = (f"library op [1, 8, {sq}, {skv}, 128] {dname} causal "
                   "(top-left)")
            for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
                a, r = max_err(g, w)
                run.check(r <= TOL[dname], f"{tag}: {name} max abs err "
                          f"{a:.3e} rel {r:.3e} (tolerance rel {TOL[dname]})")
            if sq < skv:
                past = int(got[2][:, sq:].count_nonzero()
                           + got[3][:, sq:].count_nonzero())
                run.check(past == 0, f"{tag}: dk and dv past Sq exactly zero "
                          f"({past} nonzero)")


def drive_layer_gpt(run, paddle, GPTConfig, GPTForCausalLM, fa, mods, torch):
    """Phase 8b: the Layer GPT-1.3B trained with paddle.optimizer.AdamW,
    every count zeroed just before each step and read just after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = GPTConfig.gpt3_1p3b()
    b, s, steps = LAYER_GPT_BATCH, LAYER_GPT_SEQ, LAYER_GPT_STEPS
    L = cfg.num_layers
    paddle.set_device("gpu:0")
    paddle.seed(0)
    model = GPTForCausalLM(cfg)
    model.bfloat16()
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    n_params = sum(p._data.numel() for p in model.parameters())
    ids = paddle.to_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, s)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step():
        loss = model(ids, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    losses, times, per_step = [], [], []
    for _ in range(steps):
        for mod in mods:
            mod.reset_launch_counts()
        ticks0 = fa.dispatch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step()
        end.record()
        torch.cuda.synchronize()
        times.append((start.elapsed_time(end),
                      (time.perf_counter() - t0) * 1e3))
        per_step.append(({n: c for mod in mods
                          for n, c in mod.LAUNCHES.items()},
                         fa.dispatch_counts(ticks0)))
        losses.append(float(loss))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {n: L if n in fa.LAUNCHES else 0 for n in per_step[0][0]}
    run.check(all(launches == want
                  and dispatch == {("nn.sdpa", "library_flash"): L}
                  for launches, dispatch in per_step),
              f"layer gpt-1.3b: every step dispatches scaled_dot_product_"
              f"attention to the library op {L} times and launches each of "
              f"its kernels {L} times, no other attention kernel (step 0: "
              f"{per_step[0]})")
    run.check(math.isfinite(losses[0]) and all(map(math.isfinite, losses)),
              f"layer gpt-1.3b: losses finite {[round(x, 4) for x in losses]}")
    run.check(losses[-1] < losses[0],
              f"layer gpt-1.3b: loss falls, {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
    timed = [t[0] for t in times[1:]]
    ms = float(np.median(timed))
    tok_s = b * s / (ms / 1e3)

    def fwd_bwd():
        model(ids, ids).backward()

    fb_ms = windows_ms(fwd_bwd, reps=1, windows=3)
    opt_ms = windows_ms(opt.step, reps=1, windows=3)
    opt.clear_grad()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    idle = max(0.0, 1 - busy / wall_ms)
    print(f"layer gpt-1.3b (GPTConfig.gpt3_1p3b(), {n_params} parameters, "
          f"bf16 + AdamW multi_precision, B{b} S{s}): losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"layer gpt-1.3b: {ms:.2f} ms/step (device events, median of steps "
          f"2-{steps}, spread {max(timed) - min(timed):.2f}; host clock "
          f"{[round(t[1], 2) for t in times]}), {tok_s:.1f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB", flush=True)
    print(f"layer gpt-1.3b: forward+backward {fb_ms[0]:.2f} ms (spread "
          f"{fb_ms[1]:.2f}), optimizer {opt_ms[0]:.2f} ms (spread "
          f"{opt_ms[1]:.2f}) (device events); profiled step {wall_ms:.2f} ms "
          f"wall, {busy:.2f} ms kernel time, idle share {idle:.3f}",
          flush=True)
    for key, kms, count in rows[:12]:
        print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
    return {"losses": losses, "ms_per_step": ms,
            "ms_per_step_spread": max(timed) - min(timed),
            "step_ms": [t[0] for t in times], "tokens_per_s": tok_s,
            "fwd_bwd_ms": fb_ms[0], "fwd_bwd_ms_spread": fb_ms[1],
            "optimizer_ms": opt_ms[0], "optimizer_ms_spread": opt_ms[1],
            "profiled_ms": wall_ms, "kernel_ms": busy, "idle_share": idle,
            "peak_memory_gb": peak_gb, "parameters": n_params,
            "launches": {n: sum(st[0][n] for st in per_step)
                         for n in per_step[0][0]},
            "steps": steps}


# ---------------------------------------------------------------- phase 9
# 9a: the requests of tests/test_continuous_batching.py:31 (prompt length,
# budget; prompts from RandomState(3)) through two slots of a 64-token cache.
SERVING_SMALL_REQUESTS = ((5, 12), (3, 4), (9, 6))
# 9a: a continuous-batching token may differ from the isolated run's only
# at a step whose top-2 logit margin is under this share of the logit scale.
NEAR_TIE = 1e-4
# 9b: LlamaConfig.llama2_7b() (Touvron et al. 2023, Llama 2, Table 1: 7B),
# bf16 weights, the caches at the reference's f32 default.
SCORING_BATCH, SCORING_SEQ = 4, 1024
SERVING_BATCH, SERVING_PROMPT, SERVING_NEW = 8, 512, 128
SERVING_CAPACITY = 2048
CB_SLOTS, CB_REQUESTS = 8, 24
CB_PROMPT, CB_BUDGET = (64, 1024), (16, 128)     # inclusive ranges
# The first decoded token must be the scoring forward's argmax wherever
# that forward's top-2 margin exceeds this many bf16 steps (2^-8) of the
# logit scale: the two paths round the attention differently (the library
# kernel's bf16 P against the cache einsum's f32), and 32 layers carry it.
BF16_STEPS = 8
# the decode step profiled for the idle share (one of SERVING_NEW - 1)
PROFILED_DECODE_STEP = 64


def greedy_margins(paddle, model, seqs, plen, torch):
    """Top-2 logit margins of a greedy continuation, recomputed by the
    no-cache forward over prompt + generated tokens: [B, n] margins at the
    n positions that chose a generated token, and the logit scale (the
    largest |logit| there)."""
    with paddle.no_grad():
        logits = model(paddle.to_tensor(seqs[:, :-1]))._data.float()
    picked = logits[:, plen - 1:]
    top2 = torch.topk(picked, 2, dim=-1).values
    return ((top2[..., 0] - top2[..., 1]).cpu().numpy(),
            float(picked.abs().max()))


def check_small_serving(run, paddle, torch):
    """Phase 9a: tiny Llama (GQA: 4 heads, 2 kv) and tiny GPT in f32, from
    one state_dict each: DecodeSession's greedy ids on the card against the
    CPU's plain path, and a ContinuousBatchingSession with overlapping
    lifetimes on the card against isolated DecodeSession runs there. Returns
    the smallest margins seen, as shares of the logit scale."""
    from paddle_tpu_torch.inference.decode import (ContinuousBatchingSession,
                                                   DecodeSession)
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, 256, (n,)).astype(np.int32), budget)
            for n, budget in SERVING_SMALL_REQUESTS]
    ids = np.random.RandomState(4).randint(0, 256, (2, 8)).astype(np.int32)
    models = (("llama", lambda: LlamaForCausalLM(LlamaConfig.tiny())),
              ("gpt", lambda: GPTForCausalLM(GPTConfig.tiny())))
    out = {}
    for name, build in models:
        paddle.set_device("cpu")
        paddle.seed(0)
        state = {k: v.numpy() for k, v in build().state_dict().items()}
        got = {}
        for dev in ("cpu", "gpu:0"):
            paddle.set_device(dev)
            model = build()
            model.set_state_dict(state)
            got[dev] = (model, DecodeSession(model, 64).generate(
                ids, max_new_tokens=12).numpy())
        model, card_ids = got["gpu:0"]
        margins, scale = greedy_margins(paddle, model, card_ids, 8, torch)
        tag = f"serving small {name} (f32)"
        run.check(np.array_equal(card_ids, got["cpu"][1]),
                  f"{tag}: DecodeSession greedy ids on the card equal the "
                  f"CPU's (B2, prompt 8, 12 new; smallest top-2 margin "
                  f"{margins.min() / scale:.3e} of the logit scale)")
        sess = ContinuousBatchingSession(model, max_slots=2, max_length=64)
        rids = [sess.submit(p, b) for p, b in reqs]
        completed = []
        while sess._queue or sess._running or sess._pending:
            completed.extend(sess.step())
        res = sess.run()
        counts = sess.executable_counts()
        sess.close()
        run.check(completed.index(rids[1]) < completed.index(rids[0]),
                  f"{tag}: continuous batching, 3 requests through 2 slots: "
                  f"request 1 retires before request 0 (order {completed})")
        worst = math.inf
        for rid, (prompt, budget) in zip(rids, reqs):
            iso = DecodeSession(model, 64).generate(
                prompt[None], max_new_tokens=budget).numpy()
            m, sc = greedy_margins(paddle, model, iso, len(prompt), torch)
            worst = min(worst, float(m.min()) / sc)
            diff = np.flatnonzero(res[rid][len(prompt):] !=
                                  iso[0, len(prompt):])
            first = int(diff[0]) if diff.size else None
            run.check(first is None or m[0, first] < NEAR_TIE * sc,
                      f"{tag}: continuous batching request {rid} equals "
                      f"its isolated DecodeSession run on the card"
                      + ("" if first is None else
                         f" up to step {first}, where the isolated run's "
                         f"top-2 margin is {m[0, first] / sc:.3e} of the "
                         f"logit scale (allowed under {NEAR_TIE})"))
        print(f"{tag}: continuous batching smallest top-2 margin "
              f"{worst:.3e} of the logit scale; programs (admit, decode) "
              f"{counts}", flush=True)
        out[name] = {"decode_min_margin": float(margins.min()) / scale,
                     "cb_min_margin": worst, "cb_programs": list(counts)}
    paddle.set_device("gpu:0")
    return out


def _event_timed(torch, fn, log, profile_at=None, profiled=None):
    """fn wrapped to record CUDA events around each call into ``log``; the
    call numbered ``profile_at`` instead runs alone under torch.profiler
    (synchronized before and after), its (profiler, wall ms) in
    ``profiled``."""
    from torch.profiler import ProfilerActivity, profile

    def wrapped(*args, **kwargs):
        if profile_at is not None and len(log) + len(profiled) == profile_at:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                r = fn(*args, **kwargs)
                torch.cuda.synchronize()
                profiled.append((prof, (time.perf_counter() - t0) * 1e3))
            return r
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = fn(*args, **kwargs)
        end.record()
        log.append((start, end))
        return r
    return wrapped


def _device_rows(prof):
    from torch.autograd import DeviceType
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])


def drive_serving(run, paddle, fa, mods, torch):
    """Phase 9b: Llama-2-7B (LlamaConfig.llama2_7b(), random weights from
    seed 0, bf16) built on the card: the no-cache scoring forward through
    the library kernel, a DecodeSession, and a ContinuousBatchingSession,
    every count zeroed just before the forward it checks."""
    from paddle_tpu_torch.inference.decode import (ContinuousBatchingSession,
                                                   DecodeSession)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import metrics as met
    cfg = LlamaConfig.llama2_7b()
    L, V = cfg.num_layers, cfg.vocab_size
    paddle.set_device("gpu:0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paddle.seed(0)
    model = LlamaForCausalLM(cfg)
    model.bfloat16()
    model.eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = model.parameters()
    n_params = sum(p._data.numel() for p in params)
    weight_bytes = sum(p._data.numel() * p._data.element_size()
                       for p in params)
    print(f"serving llama-2-7b (LlamaConfig.llama2_7b(), {n_params} "
          f"parameters, bf16): built on the card in {build_s:.1f} s",
          flush=True)

    # the no-cache scoring forward at B4 S1024 (eval), through the library
    # forward kernel; counted over one forward, then over the timed ones
    def score(t):
        with paddle.no_grad():
            return model(t)

    t_score = paddle.to_tensor(np.random.RandomState(1).randint(
        0, V, (SCORING_BATCH, SCORING_SEQ)))
    want = {n: L if n == "library_flash_fwd" else 0
            for mod in mods for n in mod.LAUNCHES}
    for calls, what in ((1, "one forward"), (4, "the timed forwards")):
        for mod in mods:
            mod.reset_launch_counts()
        ticks0 = fa.dispatch_counts()
        if calls == 1:
            logits = score(t_score)._data
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(logits).all())
            del logits
        else:
            score_ms = windows_ms(lambda: score(t_score), reps=1, windows=3)
        launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
        dispatch = fa.dispatch_counts(ticks0)
        run.check(launches == {n: c * calls for n, c in want.items()}
                  and dispatch == {("nn.sdpa", "library_flash"): L * calls},
                  f"serving llama-2-7b scoring forward (B{SCORING_BATCH} "
                  f"S{SCORING_SEQ}), {what}: {L} launches of the library "
                  f"forward kernel a forward, nn.sdpa{{library_flash}} {L} "
                  f"times, no other attention kernel (launches {launches}, "
                  f"dispatch {dispatch})")
    run.check(finite, "serving llama-2-7b scoring forward: finite logits")

    # the scoring forward on the DecodeSession's prompts: its argmax at the
    # last prompt position, and what the cached forward gives there
    prompts = np.random.RandomState(0).randint(
        0, V, (SERVING_BATCH, SERVING_PROMPT)).astype(np.int32)
    last = score(paddle.to_tensor(prompts))._data[:, -1].float()
    top2 = torch.topk(last, 2, dim=-1)
    argmax = top2.indices[:, 0].cpu().numpy()
    margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
    scale = float(last.abs().max())
    tie_bound = BF16_STEPS * 2.0 ** -8 * scale
    with paddle.no_grad():
        cached, _ = model.forward_with_cache(
            paddle.to_tensor(prompts),
            model.init_cache(SERVING_BATCH, max_length=SERVING_PROMPT))
    path_diff = float((cached._data[:, -1].float() - last).abs().max())
    del cached, last
    torch.cuda.empty_cache()

    # DecodeSession: B8 prompts of 512, 128 greedy tokens, capacity 2048
    sess = DecodeSession(model, max_length=SERVING_CAPACITY)
    pre_log, dec_log, profiled = [], [], []
    sess._prefill = _event_timed(torch, sess._prefill, pre_log)
    sess._decode = _event_timed(torch, sess._decode, dec_log,
                                PROFILED_DECODE_STEP, profiled)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = sess.generate(prompts, max_new_tokens=SERVING_NEW).numpy()
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_ms = pre_log[0][0].elapsed_time(pre_log[0][1])
    step_ms = [s.elapsed_time(e) for s, e in dec_log]
    decode_ms = float(np.median(step_ms))
    prof, prof_wall = profiled[0]
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    idle = max(0.0, 1 - busy / prof_wall)
    first = gen[:, SERVING_PROMPT]
    decided = margin > tie_bound
    run.check(gen.shape == (SERVING_BATCH, SERVING_PROMPT + SERVING_NEW)
              and bool(((gen >= 0) & (gen < V)).all()),
              f"serving llama-2-7b DecodeSession: {gen.shape} in-vocab ids")
    run.check(bool((first[decided] == argmax[decided]).all()),
              f"serving llama-2-7b: the first decoded token equals the "
              f"scoring forward's argmax for every sequence whose top-2 "
              f"margin exceeds the bf16 bound {tie_bound:.4f} ({BF16_STEPS} "
              f"bf16 steps of the logit scale {scale:.4f}): "
              f"{int(decided.sum())} of {SERVING_BATCH} decided, first "
              f"tokens {first.tolist()}, argmax {argmax.tolist()}, margins "
              f"{[round(float(m), 4) for m in margin]}; the cached forward's "
              f"last-position logits differ from the scoring forward's by "
              f"at most {path_diff:.4f}")
    d = cfg.hidden_size // cfg.num_heads
    cache_bytes = 2 * L * SERVING_BATCH * SERVING_CAPACITY \
        * cfg.num_kv_heads * d * 4
    emb = model.llama.embed_tokens.weight._data
    step_weight_bytes = weight_bytes - emb.numel() * emb.element_size() \
        + SERVING_BATCH * cfg.hidden_size * emb.element_size()
    bound_ms = (step_weight_bytes + cache_bytes) / PEAK_HBM_BYTES * 1e3
    run.check(peak_gb * 1e9 < weight_bytes + 1.5 * cache_bytes,
              f"serving llama-2-7b DecodeSession: peak memory {peak_gb:.2f}"
              f" GB holds one cache ({cache_bytes / 1e9:.2f} GB) beside the "
              f"weights ({weight_bytes / 1e9:.2f} GB), not two")
    tok_s = SERVING_BATCH * SERVING_NEW / gen_s
    print(f"serving llama-2-7b scoring forward B{SCORING_BATCH} "
          f"S{SCORING_SEQ}: {score_ms[0]:.2f} ms (device events, median of "
          f"3, spread {score_ms[1]:.2f})", flush=True)
    print(f"serving llama-2-7b DecodeSession B{SERVING_BATCH} prompt "
          f"{SERVING_PROMPT}, {SERVING_NEW} new, capacity "
          f"{SERVING_CAPACITY}: prefill {prefill_ms:.2f} ms; decode "
          f"{decode_ms:.2f} ms/token (median of {len(step_ms)} steps, "
          f"spread {max(step_ms) - min(step_ms):.2f}); generate "
          f"{gen_s:.2f} s wall, {tok_s:.1f} decoded tokens/s; peak memory "
          f"{peak_gb:.2f} GB", flush=True)
    print(f"serving llama-2-7b decode step {PROFILED_DECODE_STEP} profiled: "
          f"{prof_wall:.2f} ms wall, {busy:.2f} ms kernel time, idle share "
          f"{idle:.3f}; bytes bound {bound_ms:.3f} ms "
          f"({step_weight_bytes / 1e9:.2f} GB of bf16 weights + "
          f"{cache_bytes / 1e9:.2f} GB of f32 "
          f"k/v over the whole capacity, at 3.35 TB/s), the step at "
          f"{bound_ms / decode_ms:.3f} of it", flush=True)
    for key, kms, count in rows[:8]:
        print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
    del sess, gen
    torch.cuda.empty_cache()

    # ContinuousBatchingSession: 24 requests submitted at once, 8 slots
    rng = np.random.RandomState(0)
    plens = rng.randint(CB_PROMPT[0], CB_PROMPT[1] + 1, CB_REQUESTS)
    budgets = rng.randint(CB_BUDGET[0], CB_BUDGET[1] + 1, CB_REQUESTS)
    reqs = [rng.randint(0, V, (n,)).astype(np.int32) for n in plens]
    met.REGISTRY.reset()
    sess = ContinuousBatchingSession(model, max_slots=CB_SLOTS,
                                     max_length=SERVING_CAPACITY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [sess.submit(p, int(b)) for p, b in zip(reqs, budgets)]
    res = sess.results()
    cb_s = time.perf_counter() - t0
    counts = sess.executable_counts()
    used = {next(b for b in sess._buckets if b >= n) for n in plens}
    sess.close()
    run.check(sorted(res) == sorted(rids) and all(
        res[r].ok and len(res[r].ids) == n + b
        and bool(((res[r].ids[n:] >= 0) & (res[r].ids[n:] < V)).all())
        for r, n, b in zip(rids, plens, budgets)),
        f"serving llama-2-7b ContinuousBatchingSession: all {CB_REQUESTS} "
        f"requests (prompts {int(plens.min())}-{int(plens.max())}, budgets "
        f"{int(budgets.min())}-{int(budgets.max())}) finish once, DONE, "
        f"with their budget of in-vocab tokens")
    run.check(sum(counts) <= 1 + len(used),
              f"serving llama-2-7b ContinuousBatchingSession: programs "
              f"(admit, decode) {counts} within 1 + {len(used)} buckets used")
    ttft = met.REGISTRY.histogram("serving.time_to_first_token_s")
    ttft_p50, ttft_p99 = ttft.percentile(0.5), ttft.percentile(0.99)
    cb_tok_s = int(budgets.sum()) / cb_s
    print(f"serving llama-2-7b ContinuousBatchingSession ({CB_SLOTS} slots, "
          f"capacity {SERVING_CAPACITY}, {CB_REQUESTS} requests, "
          f"{int(budgets.sum())} tokens): {cb_s:.2f} s wall, {cb_tok_s:.1f} "
          f"tokens/s; time to first token p50 {ttft_p50:.3f} s, p99 "
          f"{ttft_p99:.3f} s (serving.time_to_first_token_s); programs "
          f"{counts}", flush=True)
    return {"parameters": n_params, "build_s": build_s,
            "scoring_ms": score_ms[0], "scoring_ms_spread": score_ms[1],
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "decode_ms_spread": max(step_ms) - min(step_ms),
            "decode_tokens_per_s": tok_s, "generate_s": gen_s,
            "peak_memory_gb": peak_gb, "cache_gb": cache_bytes / 1e9,
            "decode_idle_share": idle, "decode_profiled_ms": prof_wall,
            "decode_kernel_ms": busy, "decode_bound_ms": bound_ms,
            "decode_bound_share": bound_ms / decode_ms,
            "first_token_decided": int(decided.sum()),
            "tie_bound": tie_bound, "path_diff": path_diff,
            "cb_s": cb_s, "cb_tokens_per_s": cb_tok_s,
            "cb_ttft_p50_s": ttft_p50, "cb_ttft_p99_s": ttft_p99,
            "cb_programs": list(counts), "cb_buckets_used": len(used)}

# --------------------------------------------------------------- phase 10
# 10b: the MoE GPT of benchmarks/workloads/moe_ep.py:29-37 at one device
# (the 350M-class width: h1024, 24 layers, 8 heads of 128, vocab 50304;
# 2 experts, B4 S1024), through setup() and its step like phase 4's paths.
MOE_EXPERTS = 2
MOE_PATH = ("moe_gpt", dict(vocab_size=50304, hidden_size=1024,
                            num_layers=24, num_heads=8, max_seq_len=1024),
            4, 1024, "simple", ("simple_attention_fwd",
                                "simple_attention_bwd"), 1, 3)
# Adam's step is lr * m / (sqrt(v) + eps): round-off in a gradient that is
# zero in exact arithmetic (the key bias's) becomes a step of up to 0.1 lr,
# other on each device; parameters are held to that beside 1e-4 of each
# leaf's scale.
ADAM_NOISE = 0.1 * 3e-4


def check_small_moe(run, TH, GPTConfig, mods, torch):
    """Phase 10a: a small gpt_hybrid with 2 experts (h128, 2 layers, 2 heads
    of 64, B4 S128, f32, remat "names"): kernels on the card against the
    plain path on the CPU from the same params. The loss and every gradient
    (the gate's and the experts' included) agree, and two chunks through
    build_accum_steps then one apply give the same parameters; on the card
    every attention goes through simple_attention's kernels."""
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    pcfg = TH.ParallelConfig(num_experts=MOE_EXPERTS, remat=True,
                             remat_policy="names",
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    cpu_params = TH.init_params(cfg, pcfg, torch.Generator().manual_seed(10),
                                device="cpu")
    ids = torch.from_numpy(np.random.RandomState(10).randint(
        0, cfg.vocab_size, (4, 128)))
    out = {}
    for dev in ("cpu", "cuda"):
        # copies: the apply below writes into the params in place
        params = {k: ({kk: vv.to(dev, copy=True) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev, copy=True))
                  for k, v in cpu_params.items()}
        batch = ids.to(dev)
        for mod in mods:
            mod.reset_launch_counts()
        loss, grads = TH._value_and_grad(params, (batch, batch), cfg, pcfg)
        grad_step, apply_step = TH.build_accum_steps(cfg, pcfg)
        acc = TH.init_grad_accum(params)
        opt_state = TH.adamw_init(params, pcfg)
        for chunk in batch.chunk(2):
            grad_step(params, acc, (chunk, chunk))
        apply_step(params, opt_state, acc, 2)
        launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
        out[dev] = (float(loss), [g.cpu() for g in grads],
                    [p.cpu() for p in TH._leaves(params)], launches)
    torch.cuda.synchronize()
    (lc, gc, pc, _), (lg, gg, pg, launches) = out["cpu"], out["cuda"]
    names = [n for n, _ in _named_leaves(cpu_params)]
    grad_err = {n: _leaf_err(a.numpy(), b.numpy())
                for n, a, b in zip(names, gg, gc)}
    param_err = max(float((a - b).abs().max())
                    - 1e-4 * float(b.abs().max()) for a, b in zip(pg, pc))
    tag = f"moe gpt small ({MOE_EXPERTS} experts, f32, B4 S128 D64)"
    run.check(abs(lg - lc) <= 1e-5 * abs(lc),
              f"{tag}: loss {lg:.7f} card vs {lc:.7f} cpu (tolerance rel "
              "1e-5)")
    run.check(max(grad_err.values()) <= 1e-4,
              f"{tag}: worst gradient {max(grad_err.values()):.3e} of its "
              f"leaf's scale (tolerance 1e-4); MoE leaves "
              + ", ".join(f"{n} {grad_err[n]:.1e}" for n in names
                          if n.split(".")[-1] in ("gate_w", "fc1_w", "fc2_w")))
    run.check(param_err <= ADAM_NOISE,
              f"{tag}: build_accum_steps k=2 then apply, parameters within "
              f"1e-4 of each leaf's scale + {ADAM_NOISE:.0e} (worst excess "
              f"{param_err:.3e})")
    # value_and_grad, then two chunks: each a forward and a backward of
    # every layer ("names" saves attention's output, so no recompute)
    L = cfg.num_layers
    run.check(launches == {n: 3 * L if n.startswith("simple_attention")
                           else 0 for n in launches},
              f"{tag}: {3 * L} launches of each of simple_attention's "
              f"kernels on the card and no other ({launches})")


def _named_leaves(tree, prefix=""):
    """(dotted name, leaf) in gpt_hybrid's _leaves order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], prefix + k + ".")]
    return [(prefix[:-1], tree)]


# --------------------------------------------------------------- phase 11
# 11a: a small BERT (h256, 2 layers, 4 heads of 64, vocab 512) at B2 S128,
# eval, no mask, f32. 11b: BertConfig.base() as
# benchmarks/workloads/bert_mlm_amp.py runs it in full mode.
SMALL_BERT = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                  intermediate_size=1024, max_seq_len=128)
BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 128, 10
BERT_SCALE = 2.0 ** 10


def _bert_grad_errs(got, want):
    """Each gradient's max error over its leaf's scale; the key bias's,
    zero in exact arithmetic (softmax ignores a shift shared by all keys),
    over the largest gradient of the model."""
    top = max(float(np.abs(w).max()) for w in want.values() if w is not None)
    return {n: float(np.abs(got[n] - w).max())
            / (top if n.endswith("k_proj.bias")
               else max(float(np.abs(w).max()), 1e-30))
            for n, w in want.items() if w is not None}


def check_small_bert(run, paddle, fa, mods, torch):
    """Phase 11a: the small BERT MLM in eval mode without a mask, in f32,
    on the card (the library tier) and on the CPU (plain attention) from
    one state_dict: the logits, the loss and every gradient agree, and the
    card launches the library kernels once a layer a pass and no other
    attention kernel."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    cfg = BertConfig(**SMALL_BERT)
    ids = np.random.RandomState(11).randint(0, cfg.vocab_size, (2, 128))
    paddle.seed(0)
    paddle.set_device("cpu")
    state = {k: v.numpy() for k, v in BertForMaskedLM(cfg).state_dict()
             .items()}
    out = {}
    for dev in ("cpu", "gpu:0"):
        paddle.set_device(dev)
        model = BertForMaskedLM(cfg)
        model.set_state_dict(state)
        model.eval()
        for mod in mods:
            mod.reset_launch_counts()
        ticks0 = fa.dispatch_counts()
        t = paddle.to_tensor(ids)
        logits = model(t)
        loss = model(t, labels=t)
        loss.backward()
        launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
        dispatch = fa.dispatch_counts(ticks0)
        out[dev] = (logits.numpy(), float(loss),
                    {n: None if p.grad is None else p.grad.numpy()
                     for n, p in model.named_parameters()})
    paddle.set_device("gpu:0")
    L = cfg.num_layers
    tag = "bert small (f32, eval, no mask, B2 S128 D64)"
    want = {"library_flash_fwd": 2 * L, "library_flash_bwd_dq": L,
            "library_flash_bwd_dkv": L}
    run.check(launches == {n: want.get(n, 0) for n in launches}
              and dispatch == {("nn.sdpa", "library_flash"): 2 * L},
              f"{tag}: the library kernels on the card, forward {2 * L} "
              f"(two forwards), each backward {L}, no other (launches "
              f"{launches}, dispatch {dispatch})")
    (xc, lc, gc), (xg, lg, gg) = out["cpu"], out["gpu:0"]
    errs = _bert_grad_errs(gg, gc)
    run.check(_leaf_err(xg, xc) <= 1e-4 and abs(lg - lc) <= 1e-5 * abs(lc),
              f"{tag}: logits {_leaf_err(xg, xc):.3e} of their scale "
              f"(tolerance 1e-4), loss {lg:.7f} card vs {lc:.7f} cpu "
              "(tolerance rel 1e-5)")
    run.check([n for n in gc if gc[n] is None]
              == [n for n in gg if gg[n] is None]
              and max(errs.values()) <= 1e-4,
              f"{tag}: worst gradient {max(errs.values()):.3e} of its leaf's "
              f"scale (tolerance 1e-4) over {len(errs)} leaves")


def time_library_at_bert(run, fa, torch):
    """Phase 11: the library forward at BERT-base's attention (B32 H12 S128
    D64, bf16, non-causal, as its eval forward hands it over) against its
    plain version, its time beside the plain version's and one
    scaled_dot_product_attention call's (median of 5 windows, spread), and
    its bound: 2 products of 2 * S * S * D per head against q, k, v and o
    in bf16 and the f32 lse."""
    import torch.nn.functional as F
    from paddle_tpu_torch.models.bert import BertConfig
    cfg = BertConfig.base()
    b, h, s = BERT_BATCH, cfg.num_heads, BERT_SEQ
    d = cfg.hidden_size // h
    gen = torch.Generator(device="cuda").manual_seed(111)
    q, k, v, _ = path_inputs(gen, torch.bfloat16, torch, (b, h, s, d))
    scale = 1.0 / math.sqrt(d)
    got = fa.library_flash_fwd_cuda(q, k, v, scale, False)
    want = fa.library_flash_reference(q, k, v, scale, False)
    torch.cuda.synchronize()
    err, rel = max_err(got[0], want[0])
    run.check(rel <= TOL["bfloat16"],
              f"library_flash_fwd at bert-base (B{b} H{h} S{s} D{d} bf16, "
              f"non-causal): max abs err {err:.3e} rel {rel:.3e} (tolerance "
              f"rel {TOL['bfloat16']})")
    ms = windows_ms(lambda: fa.library_flash_fwd_cuda(q, k, v, scale, False),
                    reps=20)
    plain_ms = windows_ms(
        lambda: fa.library_flash_reference(q, k, v, scale, False), reps=5)
    lib_ms = windows_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                        reps=20)
    ops_ms = 2 * 2 * b * h * s * s * d / PEAK_BF16_FLOPS * 1e3
    bytes_ms = (4 * b * h * s * d * 2 + b * h * s * 4) / PEAK_HBM_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    row = {"shape": [b, h, s, d], "causal": False, "ms": ms[0],
           "ms_spread": ms[1], "plain_ms": plain_ms[0],
           "plain_ms_spread": plain_ms[1], "library_ms": lib_ms[0],
           "library_ms_spread": lib_ms[1], "bound_ms": bound_ms,
           "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
           "max_abs_err": err}
    print(f"library_flash_fwd at bert-base (B{b} H{h} S{s} D{d}, bf16, "
          f"non-causal): {ms[0]:.4f} ms (spread {ms[1]:.4f}), bound "
          f"{bound_ms:.4f} ms ({row['bound_by']}), plain {plain_ms[0]:.4f} "
          f"ms, scaled_dot_product_attention {lib_ms[0]:.4f} ms", flush=True)
    return row


def drive_bert(run, paddle, fa, mods, torch):
    """Phase 11b: BertForMaskedLM(BertConfig.base()) trained under AMP O2 as
    benchmarks/workloads/bert_mlm_amp.py runs it in full mode, every count
    zeroed just before each step and read just after; then one eval scoring
    forward through the library kernel."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    cfg = BertConfig.base()
    L, V = cfg.num_layers, cfg.vocab_size
    b, s, steps = BERT_BATCH, BERT_SEQ, BERT_STEPS
    paddle.set_device("gpu:0")
    paddle.seed(0)
    model = BertForMaskedLM(cfg)
    opt = paddle.optimizer.AdamW(learning_rate=5e-5,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    model, opt = paddle.amp.decorate(models=model, optimizers=opt,
                                     level="O2", dtype="bfloat16")
    scaler = paddle.amp.GradScaler(init_loss_scaling=BERT_SCALE)
    lossf = paddle.nn.CrossEntropyLoss()
    n_params = sum(p._data.numel() for p in model.parameters())
    # the workload's batches (fresh ids, 15 % set to 0, labels = ids), made
    # in its order from RandomState(0), all before the first step
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(steps):
        ids = rng.randint(0, V, (b, s))
        labels = ids.copy()
        ids[rng.rand(b, s) < 0.15] = 0
        batches.append((paddle.to_tensor(ids), paddle.to_tensor(labels)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def forward_backward(xb, yb):
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(xb)
            loss = lossf(logits.reshape([-1, V]), yb.reshape([-1]))
        opt.clear_grad()
        scaler.scale(loss).backward()
        return loss

    def scaler_step():
        scaler.step(opt)
        scaler.update()

    losses, times, per_step, amp_state = [], [], [], []
    for xb, yb in batches:
        for mod in mods:
            mod.reset_launch_counts()
        ticks0 = fa.dispatch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = forward_backward(xb, yb)
        scaler_step()
        end.record()
        torch.cuda.synchronize()
        times.append((start.elapsed_time(end),
                      (time.perf_counter() - t0) * 1e3))
        per_step.append(({n: c for mod in mods
                          for n, c in mod.LAUNCHES.items()},
                         fa.dispatch_counts(ticks0)))
        amp_state.append((scaler.found_inf,
                          float(scaler.get_loss_scaling())))
        losses.append(float(loss))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tag = "bert-base mlm amp O2"
    run.check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"{tag}: losses finite and the last below the first "
              f"{[round(x, 4) for x in losses]}")
    masters = list(opt._master_weights.values())
    accs = [t for d in opt._accumulators.values() for t in d.values()]
    trained = {id(p) for p in model.parameters() if p.grad is not None}
    run.check(all(p.dtype == paddle.bfloat16 for p in model.parameters())
              and set(opt._master_weights) == trained
              and all(m.dtype == paddle.float32 for m in masters + accs),
              f"{tag}: params bf16; {len(masters)} master weights (one for "
              f"each of the {len(trained)} trained params) and {len(accs)} "
              "accumulators (moments, beta powers) f32")
    run.check(all(st == (False, BERT_SCALE) for st in amp_state),
              f"{tag}: found_inf false and the scale {BERT_SCALE:.0f} on "
              f"every step ({amp_state[0]} ... {amp_state[-1]})")
    run.check(all(not any(launches.values())
                  and dispatch == {("nn.sdpa", "plain"): L}
                  for launches, dispatch in per_step),
              f"{tag}: training steps (dropout 0.1) send attention to the "
              f"plain route {L} times a step and launch no attention kernel "
              f"(step 0: {per_step[0]})")

    # one eval scoring forward, no mask, dropout off: the library forward
    model.eval()
    for mod in mods:
        mod.reset_launch_counts()
    ticks0 = fa.dispatch_counts()
    with paddle.no_grad(), paddle.amp.auto_cast(level="O2",
                                                dtype="bfloat16"):
        scores = model(batches[0][0])
    torch.cuda.synchronize()
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    dispatch = fa.dispatch_counts(ticks0)
    model.train()
    run.check(launches == {n: L if n == "library_flash_fwd" else 0
                           for n in launches}
              and dispatch == {("nn.sdpa", "library_flash"): L}
              and list(scores.shape) == [b, s, V]
              and bool(paddle.isfinite(scores.astype("float32")).all()),
              f"{tag}: the eval scoring forward (B{b} S{s}, no mask) "
              f"launches the library forward {L} times and no other "
              f"attention kernel, finite [{b}, {s}, {V}] scores (launches "
              f"{launches}, dispatch {dispatch})")

    timed = [t[0] for t in times[1:]]
    ms = float(np.median(timed))
    xb, yb = batches[0]
    fb_ms = windows_ms(lambda: forward_backward(xb, yb), reps=1, windows=3)
    opt_ms = windows_ms(scaler_step, reps=1, windows=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward_backward(xb, yb)
        scaler_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    idle = max(0.0, 1 - busy / wall_ms)
    print(f"{tag} (BertConfig.base(), {n_params} parameters, AdamW(5e-5, "
          f"multi_precision), GradScaler(2^10), B{b} S{s}): losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"{tag}: {ms:.2f} ms/step (device events, median of steps "
          f"2-{steps}, spread {max(timed) - min(timed):.2f}; host clock "
          f"{[round(t[1], 2) for t in times]}), {b / (ms / 1e3):.1f} "
          f"sequences/s, {b * s / (ms / 1e3):.1f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB", flush=True)
    print(f"{tag}: forward+backward {fb_ms[0]:.2f} ms (spread "
          f"{fb_ms[1]:.2f}), scaler+optimizer {opt_ms[0]:.2f} ms (spread "
          f"{opt_ms[1]:.2f}) (device events); profiled step {wall_ms:.2f} ms "
          f"wall, {busy:.2f} ms kernel time, idle share {idle:.3f}",
          flush=True)
    for key, kms, count in rows[:12]:
        print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
    return {"losses": losses, "ms_per_step": ms,
            "ms_per_step_spread": max(timed) - min(timed),
            "step_ms": [t[0] for t in times],
            "host_step_ms": [t[1] for t in times],
            "sequences_per_s": b / (ms / 1e3),
            "tokens_per_s": b * s / (ms / 1e3),
            "fwd_bwd_ms": fb_ms[0], "fwd_bwd_ms_spread": fb_ms[1],
            "scaler_optimizer_ms": opt_ms[0],
            "scaler_optimizer_ms_spread": opt_ms[1],
            "profiled_ms": wall_ms, "kernel_ms": busy, "idle_share": idle,
            "top_rows": [[k[:80], round(t, 4), c] for k, t, c in rows[:8]],
            "peak_memory_gb": peak_gb, "parameters": n_params,
            "eval_library_fwd_launches": launches["library_flash_fwd"]}


# --------------------------------------------------------------- phase 12
# 12a: resnet18(num_classes=10) at B4 32x32 f32 on the card against the CPU
# from one state_dict; values (logits, loss, BatchNorm's running buffers)
# within 1e-4 and gradients within 1e-3 of each leaf's scale, and so the
# parameters after the step too: a BatchNorm bias starts at 0, so after one
# step it is -lr x its gradient (cuDNN's and the CPU's f32 convolutions sum
# in other orders, and train-mode BatchNorm over few values amplifies the
# difference).
# 12b: benchmarks/workloads/resnet50_cifar10.py:29-41 in full mode: 3
# warm-up and 20 timed steps, then 5 under FLAGS_matmul_precision="default"
# (TF32 convolutions). 12c: its loader with 4 forked workers after CUDA is
# initialised, 20 batches, against the single-process loader.
RESNET_SMALL_BATCH = 4
RESNET_TOL = {"values": 1e-4, "gradients": 1e-3}
RESNET_BATCH, RESNET_WARMUP, RESNET_STEPS, RESNET_TF32_STEPS = 256, 3, 20, 5
LOADER_WORKERS, LOADER_BATCHES = 4, 20
PEAK_F32_FLOPS = 67e12       # H100 SXM, f32 on the CUDA cores
PEAK_TF32_FLOPS = 495e12     # H100 SXM, dense TF32 tensor cores


def _resnet_step(paddle, model, x, y):
    """One train-mode step of the workload's (Momentum(0.1, 0.9,
    weight_decay=5e-4)): the logits, loss, gradients, and the parameters
    and BatchNorm buffers after it, as numpy."""
    opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters(),
                                    weight_decay=5e-4)
    logits = model(paddle.to_tensor(x))
    loss = paddle.nn.CrossEntropyLoss()(logits, paddle.to_tensor(y))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    opt.step()
    return (logits.numpy(), float(loss), grads,
            {k: v.numpy() for k, v in model.state_dict().items()})


def check_small_resnet(run, paddle, torch):
    """Phase 12a: resnet18 on the card against the CPU from one state_dict:
    a train-mode forward at B1, where layer4's BatchNorms see one value a
    channel, then one step at B4."""
    from paddle_tpu_torch.vision.datasets import FakeData
    from paddle_tpu_torch.vision.models import resnet18
    items = [FakeData(size=RESNET_SMALL_BATCH)[i]
             for i in range(RESNET_SMALL_BATCH)]
    x = np.stack([img for img, _ in items])
    y = np.asarray([label for _, label in items])
    out = {}
    try:
        paddle.set_device("cpu")
        paddle.seed(0)
        state0 = {k: v.numpy()
                  for k, v in resnet18(num_classes=10).state_dict().items()}
        for dev in ("cpu", "gpu:0"):
            paddle.set_device(dev)
            model = resnet18(num_classes=10)
            model.set_state_dict(state0)
            model.train()
            one = model(paddle.to_tensor(x[:1])).numpy()
            out[dev] = (one,) + _resnet_step(paddle, model, x, y)
    finally:
        paddle.set_device("gpu:0")
    (one, logits, loss, grads, state), want = out["gpu:0"], out["cpu"]
    buffers = [k for k in state if k.endswith(("._mean", "._variance"))]
    err1 = _leaf_err(one, want[0])
    run.check(one.shape == (1, 10) and bool(np.isfinite(one).all())
              and err1 <= RESNET_TOL["values"],
              "resnet18 train-mode forward at B1 on the card (one value a "
              f"channel in layer4's BatchNorms): finite [1, 10] logits, "
              f"{err1:.3g} from the CPU's")
    tag = f"resnet18 B{RESNET_SMALL_BATCH} 32x32 f32, card against CPU"
    errs = {"logits": _leaf_err(logits, want[1]),
            "loss": abs(loss - want[2]) / abs(want[2]),
            "gradients": max(_leaf_err(g, want[3][n])
                             for n, g in grads.items()),
            "parameters": max(_leaf_err(v, want[4][k])
                              for k, v in state.items() if k not in buffers),
            "buffers": max(_leaf_err(state[k], want[4][k])
                           for k in buffers)}
    worst = max(grads, key=lambda n: _leaf_err(grads[n], want[3][n]))
    print(f"{tag}: loss {loss:.6f} (CPU {want[2]:.6f}); largest errors "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (gradient of {worst})", flush=True)
    run.check(set(grads) == set(want[3]) and set(state) == set(want[4])
              and max(errs["gradients"], errs["parameters"])
              <= RESNET_TOL["gradients"]
              and max(errs["logits"], errs["loss"], errs["buffers"])
              <= RESNET_TOL["values"],
              f"{tag}: logits, loss and the {len(buffers)} BatchNorm "
              f"buffers within {RESNET_TOL['values']}, the {len(grads)} "
              "gradients and the parameters after one Momentum step within "
              f"{RESNET_TOL['gradients']}")
    return {"errors": errs, "b1_error": err1}


def resnet_flops(model, x, torch):
    """Multiply-adds x 2 of one forward, from the shapes the model's Conv2D
    and Linear layers see: 2 * output elements * (in channels / groups *
    kernel area) for a convolution, 2 * rows * in * out for a product."""
    from paddle_tpu_torch import nn
    total = [0]

    def conv(layer, inputs, out):
        k = layer.weight.shape
        total[0] += 2 * int(np.prod(out.shape)) * k[1] * k[2] * k[3]

    def linear(layer, inputs, out):
        total[0] += 2 * int(np.prod(out.shape)) * layer.weight.shape[0]

    hooks = [layer.register_forward_post_hook(
        conv if isinstance(layer, nn.Conv2D) else linear)
        for layer in model.sublayers()
        if isinstance(layer, (nn.Conv2D, nn.Linear))]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


def drive_resnet50(run, paddle, torch):
    """Phase 12b: the workload's full mode, its eager train_step timed step
    by step (the data wait on the host, forward+backward and optimizer by
    CUDA events), one profiled step, then TF32 steps."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import Cifar10, FakeData
    from paddle_tpu_torch.vision.models import resnet50
    paddle.set_device("gpu:0")
    paddle.seed(0)
    np.random.seed(0)
    model = resnet50(num_classes=10)
    opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters(),
                                    weight_decay=5e-4)
    lossf = nn.CrossEntropyLoss()
    try:
        ds = Cifar10(mode="train")
    except FileNotFoundError:
        ds = FakeData(size=256, image_shape=(3, 32, 32), num_classes=10)
    dl = DataLoader(ds, batch_size=RESNET_BATCH, shuffle=True)
    model.train()
    events = []

    def train_step(xb, yb):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = lossf(model(xb), yb)
        opt.clear_grad()
        loss.backward()
        ev[1].record()
        opt.step()
        ev[2].record()
        events.append(ev)
        return loss

    it = iter(dl)

    def batch():
        nonlocal it
        try:
            return next(it)
        except StopIteration:
            it = iter(dl)
            return next(it)

    def steps(n):
        rows = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xb, yb = batch()
            t1 = time.perf_counter()
            loss = float(train_step(xb, yb))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            fb, op = (events[-1][0].elapsed_time(events[-1][1]),
                      events[-1][1].elapsed_time(events[-1][2]))
            rows.append({"ms": (t2 - t0) * 1e3, "data_ms": (t1 - t0) * 1e3,
                         "fwd_bwd_ms": fb, "optimizer_ms": op,
                         "loss": loss})
        return rows

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = steps(RESNET_WARMUP)
    timed = steps(RESNET_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    xb, yb = batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(train_step(xb, yb))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    idle = max(0.0, 1 - busy / wall_ms)
    paddle.set_flags({"FLAGS_matmul_precision": "default"})
    try:
        tf32_ok = torch.backends.cudnn.allow_tf32
        tf32 = steps(1 + RESNET_TF32_STEPS)    # cuDNN picks TF32 kernels
    finally:
        paddle.set_flags({"FLAGS_matmul_precision": "highest"})
    losses = [r["loss"] for r in warm + timed + tf32]
    tf32 = tf32[1:]
    flops = 3 * resnet_flops(model, xb, torch)

    def stats(rs, key):
        v = [r[key] for r in rs]
        return float(np.median(v)), max(v) - min(v)

    ms, spread = stats(timed, "ms")
    data_ms, data_spread = stats(timed, "data_ms")
    tf32_ms, tf32_spread = stats(tf32, "ms")
    out = {"ms_per_step": ms, "ms_per_step_spread": spread,
           "step_ms": [r["ms"] for r in timed],
           "images_per_s": RESNET_BATCH / (ms / 1e3),
           "data_wait_ms": data_ms, "data_wait_ms_spread": data_spread,
           "fwd_bwd_ms": stats(timed, "fwd_bwd_ms")[0],
           "optimizer_ms": stats(timed, "optimizer_ms")[0],
           "profiled_ms": wall_ms, "kernel_ms": busy, "idle_share": idle,
           "top_rows": [[k[:80], round(t, 4), c] for k, t, c in rows[:8]],
           "peak_memory_gb": peak_gb, "losses": losses,
           "train_flops_per_step": flops,
           "tflops": flops / (ms / 1e3) / 1e12,
           "f32_peak_share": flops / (ms / 1e3) / PEAK_F32_FLOPS,
           "tf32_ms_per_step": tf32_ms, "tf32_ms_per_step_spread": tf32_spread,
           "tf32_images_per_s": RESNET_BATCH / (tf32_ms / 1e3),
           "tf32_fwd_bwd_ms": stats(tf32, "fwd_bwd_ms")[0],
           "tf32_peak_share": flops / (tf32_ms / 1e3) / PEAK_TF32_FLOPS,
           "dataset": type(ds).__name__}
    tag = "resnet50 cifar10 full mode"
    print(f"{tag} ({type(ds).__name__}, B{RESNET_BATCH} 32x32, f32, "
          f"Momentum(0.1, 0.9, weight_decay=5e-4)): losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"{tag}: {ms:.2f} ms/step (host clock, each step timed alone, "
          f"median of {RESNET_STEPS}, spread {spread:.2f}), "
          f"{out['images_per_s']:.1f} images/s, data wait "
          f"{out['data_wait_ms']:.2f} ms/step, forward+backward "
          f"{out['fwd_bwd_ms']:.2f} ms, optimizer {out['optimizer_ms']:.2f} "
          f"ms (device events), peak memory {peak_gb:.2f} GB", flush=True)
    print(f"{tag}: {flops / 1e9:.1f} GFLOP a step (3x the forward's "
          f"convolutions and product), {out['tflops']:.2f} TFLOP/s, "
          f"{out['f32_peak_share']:.4f} of the f32 peak (67 TFLOP/s); "
          f"profiled step {wall_ms:.2f} ms wall, {busy:.2f} ms kernel time, "
          f"idle share {idle:.3f}", flush=True)
    for key, kms, count in rows[:8]:
        print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
    print(f"{tag} under FLAGS_matmul_precision='default' (TF32 "
          f"convolutions): {tf32_ms:.2f} ms/step (median of "
          f"{RESNET_TF32_STEPS} after one warm-up, spread "
          f"{tf32_spread:.2f}), "
          f"{out['tf32_images_per_s']:.1f} images/s, forward+backward "
          f"{out['tf32_fwd_bwd_ms']:.2f} ms, {out['tf32_peak_share']:.4f} of "
          "the TF32 peak (495 TFLOP/s)", flush=True)
    run.check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"{tag}: losses finite and the last below the first "
              f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    run.check(tf32_ok and not torch.backends.cudnn.allow_tf32,
              f"{tag}: the flag turned TF32 convolutions on for its steps "
              "and off after them")
    return out


def check_forked_loader(run, paddle, torch):
    """Phase 12c: phase 12b's loader, seeded, with forked workers after
    CUDA is initialised: its batches land on the card and equal the
    single-process loader's bit for bit."""
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import FakeData
    paddle.set_device("gpu:0")
    ds = FakeData(size=256, image_shape=(3, 32, 32), num_classes=10)
    got, host_ms = {}, {}
    for workers in (0, LOADER_WORKERS):
        dl = DataLoader(ds, batch_size=RESNET_BATCH, shuffle=True, seed=0,
                        num_workers=workers)
        batches = []
        t0 = time.perf_counter()
        while len(batches) < LOADER_BATCHES:
            for xb, yb in dl:
                batches.append((xb, yb))
                if len(batches) == LOADER_BATCHES:
                    break
        torch.cuda.synchronize()
        host_ms[workers] = (time.perf_counter() - t0) * 1e3 / LOADER_BATCHES
        got[workers] = batches
    same = all(torch.equal(a._data, b._data)
               for sp, mp in zip(got[0], got[LOADER_WORKERS])
               for a, b in zip(sp, mp))
    on_card = all(t._data.is_cuda for b in got[LOADER_WORKERS] for t in b)
    print(f"loader: {host_ms[0]:.2f} ms a batch in one process, "
          f"{host_ms[LOADER_WORKERS]:.2f} ms with {LOADER_WORKERS} forked "
          f"workers (host clock, {LOADER_BATCHES} batches of "
          f"{RESNET_BATCH})", flush=True)
    run.check(same and on_card and len(got[LOADER_WORKERS]) == LOADER_BATCHES,
              f"loader with {LOADER_WORKERS} workers forked after CUDA was "
              f"initialised: {LOADER_BATCHES} batches on the card, equal bit "
              "for bit to the single-process loader's (seed 0)")
    return {"ms_per_batch_single_process": host_ms[0],
            "ms_per_batch_workers": host_ms[LOADER_WORKERS],
            "workers": LOADER_WORKERS}


# --------------------------------------------------------------- phase 13
# GPT-3 Medium's published widths (Brown et al. 2020, Table 2.1: d_model
# 1024, 24 layers, 16 heads of 64) as the Layer GPT, trained through
# Model.fit at B4 S2048 with the training-robustness machinery on.
MEDIUM = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
              num_heads=16, max_seq_len=2048)
MEDIUM_BATCH, MEDIUM_SEQ, MEDIUM_STEPS = 4, 2048, 8
MEDIUM_FLOPS_PER_TOKEN = 2.7395e9     # PERF.md §2: 350M-class at S2048
FIT_CKPT_EVERY = 4
# 13a: (loss relative, parameter of its leaf's scale), phase 8a's f32 pair
FIT_SMALL_TOL = LAYER_TOL["float32"]


def _token_dataset(paddle, n, seq, vocab, seed):
    """n seeded token sequences, each item (ids, ids): the labels are the
    ids, shifted by the loss."""
    ids = np.random.RandomState(seed).randint(0, vocab, (n, seq))

    class Tokens(paddle.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return ids[i], ids[i]
    return Tokens()


def _lm_loss(paddle, nan_at=None):
    """The Layer GPT's own next-token loss over (logits, labels); the call
    numbered ``nan_at`` (1-based) returns NaN (13d's poisoned batch)."""
    ce = paddle.nn.CrossEntropyLoss()
    calls = [0]

    def loss(logits, labels):
        calls[0] += 1
        v = logits.shape[-1]
        out = ce(logits[:, :-1].reshape([-1, v]),
                 labels[:, 1:].reshape([-1]))
        return out * float("nan") if calls[0] == nan_at else out
    return loss


def _fit_parts(paddle, cfg_fields, batch, n_seq, seed, root, optimizer,
               every, watchdog, lr=1e-4, bf16=False, state=None):
    """A fresh Layer GPT (seed ``seed``, or ``state``'s weights), its
    optimizer, Model (with ``watchdog``), seeded DataLoader and
    FaultTolerantCheckpoint under ``root``."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.training import StepGuard
    cfg = GPTConfig(**cfg_fields)
    paddle.seed(seed)
    net = GPTForCausalLM(cfg)
    if state is not None:
        net.set_state_dict(state)
    if bf16:
        net.bfloat16()
    if optimizer == "adamw":
        opt = paddle.optimizer.AdamW(lr, parameters=net.parameters(),
                                     multi_precision=True)
    else:
        opt = paddle.optimizer.Momentum(lr, 0.9,
                                        parameters=net.parameters())
    model = paddle.Model(net)
    guard = StepGuard(check_grads=True)
    model.prepare(opt, _lm_loss(paddle), step_guard=guard,
                  watchdog=watchdog)
    loader = paddle.io.DataLoader(
        _token_dataset(paddle, n_seq, cfg.max_seq_len, cfg.vocab_size, 13),
        batch_size=batch, shuffle=True, seed=13)
    ftc = paddle.hapi.FaultTolerantCheckpoint(root, every_n_steps=every,
                                              dataloader=loader)
    return net, opt, model, guard, loader, ftc


def _state_bits(net, opt, torch):
    """Every parameter and optimizer tensor as raw bytes on the card."""
    out = {f"model.{k}": v._data.detach().reshape(-1).view(torch.uint8)
           for k, v in net.state_dict().items()}
    for k, v in opt.state_dict().items():
        if hasattr(v, "_data"):
            out[f"opt.{k}"] = v._data.detach().reshape(-1).view(torch.uint8)
    return out


def check_small_fit(run, paddle, torch):
    """Phase 13a: GPTConfig.tiny() through Model.fit, 2 steps with a
    checkpoint, then a fresh Model, optimizer and loader resuming for 2
    more, on the card and on the CPU from one seed: losses and parameters
    at phase 8a's f32 tolerance. Momentum, not Adam: Adam turns round-off
    in a gradient that is zero in exact arithmetic (the k bias's) into a
    whole step, which phase 8a sidesteps by feeding both devices one set
    of gradients and a fit cannot."""
    from paddle_tpu_torch.distributed.watchdog import TrainStepWatchdog
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    fields = {k: getattr(GPTConfig.tiny(), k)
              for k in ("vocab_size", "hidden_size", "num_layers",
                        "num_heads", "max_seq_len")}
    # one set of weights for both devices (each device's generator draws
    # its own)
    paddle.set_device("cpu")
    paddle.seed(0)
    state = {k: v.numpy() for k, v in
             GPTForCausalLM(GPTConfig(**fields)).state_dict().items()}
    out = {}
    wd = TrainStepWatchdog(timeout_s=600.0)
    for dev in ("cpu", "gpu:0"):
        paddle.set_device(dev)
        with tempfile.TemporaryDirectory() as root:
            losses = []
            for part in range(2):
                net, opt, model, _, loader, ftc = _fit_parts(
                    paddle, fields, 2, 8, 0, root, "momentum", 2, wd,
                    lr=1e-2, state=state)
                hist = model.fit(loader, epochs=1, verbose=0,
                                 callbacks=[ftc],
                                 num_iters=2 if part == 0 else None)
                losses += hist["loss"]
            resumed = ftc.resumed_from
        out[dev] = (losses, {k: v.numpy() for k, v in
                             net.state_dict().items()}, resumed)
    wd.stop()
    paddle.set_device("gpu:0")
    (lc, pc, rc), (lg, pg, rg) = out["cpu"], out["gpu:0"]
    loss_tol, leaf_tol = FIT_SMALL_TOL
    tag = "model.fit small (GPTConfig.tiny(), B2 S64, Momentum, f32)"
    run.check(len(lg) == len(lc) == 4 and rg is not None and rc is not None
              and rg.endswith("step_00000002"),
              f"{tag}: 2 steps, a checkpoint, a resume from it, 2 more "
              f"(card {len(lg)} losses, resumed from {rg})")
    rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    run.check(rel <= loss_tol, f"{tag}: losses {[round(x, 6) for x in lg]} "
              f"card vs {[round(x, 6) for x in lc]} cpu, worst rel "
              f"{rel:.2e} (tolerance {loss_tol})")
    err = max(_leaf_err(pg[k], pc[k]) for k in pc)
    run.check(err <= leaf_tol, f"{tag}: worst parameter {err:.3e} of its "
              f"leaf's scale after the resumed run (tolerance {leaf_tol})")
    return {"losses_card": lg, "losses_cpu": lc, "loss_rel": rel,
            "param_err": err}


def _fit_callback(**hooks):
    """A hapi Callback whose hooks are the given functions."""
    from paddle_tpu_torch.hapi import Callback
    cb = Callback()
    for name, fn in hooks.items():
        setattr(cb, name, fn)
    return cb


class _Clock:
    """Fit callbacks around the others: ``before`` times each train_batch
    on the host clock (its float(loss) included) and reads the step's
    kernel counts and the train.mfu gauge; ``after`` times the callbacks
    between the two (the checkpoint flush, and on_train_begin's resume)."""

    def __init__(self, mods, fa):
        from paddle_tpu_torch import observability as obs
        self.obs, self.mods, self.fa = obs, mods, fa
        self.steps, self.after_ms, self.resume_ms = [], [], None
        self.before = _fit_callback(
            on_train_begin=self._train_begin,
            on_train_batch_begin=self._batch_begin,
            on_train_batch_end=self._batch_end)
        self.after = _fit_callback(
            on_train_begin=self._resumed,
            on_train_batch_end=self._flushed)

    def _train_begin(self, logs=None):
        self.t_begin = time.perf_counter()

    def _resumed(self, logs=None):
        self.resume_ms = (time.perf_counter() - self.t_begin) * 1e3

    def _batch_begin(self, step, logs=None):
        for mod in self.mods:
            mod.reset_launch_counts()
        self.ticks0 = self.fa.dispatch_counts()
        self.t0 = time.perf_counter()

    def _batch_end(self, step, logs=None):
        self.t1 = time.perf_counter()
        self.steps.append({
            "ms": (self.t1 - self.t0) * 1e3, "loss": logs["loss"],
            "launches": {n: c for mod in self.mods
                         for n, c in mod.LAUNCHES.items()},
            "dispatch": self.fa.dispatch_counts(self.ticks0),
            "mfu": self.obs.gauge("train.mfu").value})

    def _flushed(self, step, logs=None):
        self.after_ms.append((time.perf_counter() - self.t1) * 1e3)


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _sigterm_after(at):
    """A fit callback that delivers a real SIGTERM after batch ``at``."""
    import signal

    def hook(step, logs=None):
        if step == at:
            os.kill(os.getpid(), signal.SIGTERM)
    return _fit_callback(on_train_batch_end=hook)


def time_library_at_medium(run, fa, mods, torch):
    """The library tier's three kernels at this phase's attention shape
    (B4 H16 S2048 D64, bf16 causal): held against their plain versions,
    timed beside them and beside one scaled_dot_product_attention call
    (forward; backward for dq and dk/dv together), with their bounds."""
    import torch.nn.functional as F
    shape = attention_shape("model_fit")
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, do = path_inputs(gen, torch.bfloat16, torch, shape)
    calls = kernel_calls(mods, "flash_attention", q, k, v, do,
                         1.0 / math.sqrt(shape[-1]), True)
    outputs = {kk[0]: kk[4] for kk in KERNELS}
    b, h, s, d = shape
    out = {}
    lib_fwd = windows_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        reps=10)
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd = windows_ms(lambda: torch.autograd.grad(
        o, (ql, kl, vl), do, retain_graph=True), reps=10)
    for kern in KERNELS:
        name = kern[0]
        if name not in calls:
            continue
        launch, plain = calls[name]
        worst = 0.0
        for oname, g, w in zip(outputs[name], _tuple(launch()),
                               _tuple(plain())):
            tol = TOL["float32"] if oname in ("lse", "delta") \
                else TOL["bfloat16"]
            a, r = max_err(g, w)
            worst = max(worst, a)
            run.check(r <= tol, f"{name} {oname} at B{b} H{h} S{s} D{d} "
                      f"bf16 causal: max abs err {a:.3e} rel {r:.3e} "
                      f"(tolerance rel {tol})")
        bound_ms, bound_by = bound(kern[:3] + ("model_fit",) + kern[4:])
        ms, plain_ms = windows_ms(launch, reps=10), windows_ms(plain, reps=3)
        library = lib_fwd if kern[-1] == "fwd" else lib_bwd
        out[name] = {"ms": ms[0], "ms_spread": ms[1], "plain_ms": plain_ms[0],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library[0],
                     "library_ms_spread": library[1], "max_abs_err": worst}
        print(f"{name} at B{b} H{h} S{s} D{d}: {ms[0]:.3f} ms (spread "
              f"{ms[1]:.3f}), bound {out[name]['bound_ms']:.4f} ms "
              f"({out[name]['bound_by']}), plain {plain_ms[0]:.3f} ms, "
              f"library {library[0]:.3f} ms (spread {library[1]:.3f})",
              flush=True)
    return out


def drive_model_fit(run, paddle, fa, mods, torch):
    """Phase 13b-d: GPT-3 Medium through Model.fit. Run A: 8 steps with
    checkpoints at steps 4 and 8. Run B: 4 steps, a SIGTERM that makes
    FaultTolerantCheckpoint flush a committed checkpoint and stop fit,
    then a fresh Model, optimizer and loader resuming for 4 steps: losses,
    parameters and moments bit-equal to run A's, 24 launches of each
    library kernel a step. Then a poisoned step (13d)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import checkpoint as dc
    from paddle_tpu_torch.distributed.watchdog import TrainStepWatchdog
    from paddle_tpu_torch.observability import training as otraining
    t_phase = time.perf_counter()
    b, s, steps = MEDIUM_BATCH, MEDIUM_SEQ, MEDIUM_STEPS
    L = MEDIUM["num_layers"]
    paddle.set_device("gpu:0")
    obs.enable()
    otraining.configure(flops_per_token=MEDIUM_FLOPS_PER_TOKEN)
    cache_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              ".cache")
    wd = TrainStepWatchdog(timeout_s=600.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=cache_root) as tmp:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        print(f"model.fit medium: {free_gb:.1f} GB free for checkpoints",
              flush=True)
        # ---- 13b: run A, uninterrupted
        clock_a = _Clock(mods, fa)
        net_a, opt_a, model_a, guard_a, loader_a, ftc_a = _fit_parts(
            paddle, MEDIUM, b, b * steps, 0, os.path.join(tmp, "a"),
            "adamw", FIT_CKPT_EVERY, wd, bf16=True)
        n_params = sum(p._data.numel() for p in net_a.parameters())
        hist_a = model_a.fit(loader_a, epochs=1, verbose=0, callbacks=[
            clock_a.before, ftc_a, clock_a.after])
        ckpts_a = sorted(os.listdir(os.path.join(tmp, "a")))
        ck_path = os.path.join(tmp, "a", ckpts_a[-1])
        ck_bytes = _dir_bytes(ck_path)
        save_ms = [clock_a.after_ms[i] for i in range(steps)
                   if (i + 1) % FIT_CKPT_EVERY == 0]
        bits_a = _state_bits(net_a, opt_a, torch)
        run.check(ckpts_a == ["step_00000004", "step_00000008"]
                  and all(dc.is_committed(os.path.join(tmp, "a", c))
                          for c in ckpts_a),
                  f"model.fit medium run A: committed checkpoints {ckpts_a}")
        shutil.rmtree(os.path.join(tmp, "a"), ignore_errors=True)
        # ---- 13c: run B, 4 steps, a SIGTERM, a fresh resume for 4
        clock_b = _Clock(mods, fa)
        net_b, opt_b, model_b, _, loader_b, ftc_b = _fit_parts(
            paddle, MEDIUM, b, b * steps, 0, os.path.join(tmp, "b"),
            "adamw", FIT_CKPT_EVERY, wd, bf16=True)
        hist_b1 = model_b.fit(loader_b, epochs=1, verbose=0, callbacks=[
            _sigterm_after(steps // 2 - 1), clock_b.before, ftc_b,
            clock_b.after])
        run.check(ftc_b.preempted and len(hist_b1["loss"]) == steps // 2
                  and dc.latest_committed(os.path.join(tmp, "b"))
                  .endswith(f"step_{steps // 2:08d}"),
                  f"model.fit medium run B: SIGTERM after step "
                  f"{steps // 2} flushed a committed checkpoint and stopped "
                  f"fit ({len(hist_b1['loss'])} steps, preempted "
                  f"{ftc_b.preempted})")
        del net_b, opt_b, model_b, loader_b
        gc.collect()
        torch.cuda.empty_cache()
        clock_c = _Clock(mods, fa)
        net_c, opt_c, model_c, guard_c, loader_c, ftc_c = _fit_parts(
            paddle, MEDIUM, b, b * steps, 1, os.path.join(tmp, "b"),
            "adamw", FIT_CKPT_EVERY, wd, bf16=True)
        hist_b2 = model_c.fit(loader_c, epochs=1, verbose=0, callbacks=[
            clock_c.before, ftc_c, clock_c.after])
        load_ms = clock_c.resume_ms
        losses_a = hist_a["loss"]
        losses_b = hist_b1["loss"] + hist_b2["loss"]
        bits_b = _state_bits(net_c, opt_c, torch)
        differ = sorted(k for k in bits_a
                        if k not in bits_b or not torch.equal(bits_a[k],
                                                              bits_b[k]))
        run.check(ftc_c.resumed_from is not None
                  and ftc_c.resumed_from.endswith(f"step_{steps // 2:08d}")
                  and len(losses_b) == steps,
                  f"model.fit medium run B: a fresh Model, optimizer and "
                  f"loader resumed from {ftc_c.resumed_from} for "
                  f"{len(hist_b2['loss'])} steps")
        run.check(np.array(losses_a).tobytes() == np.array(losses_b)
                  .tobytes(), f"model.fit medium: losses 1-{steps} of run B "
                  f"bit-equal to run A's ({losses_a} vs {losses_b})")
        run.check(not differ and set(bits_a) == set(bits_b),
                  f"model.fit medium: every parameter and optimizer tensor "
                  f"({len(bits_a)}) bit-equal after run B (differ: "
                  f"{differ[:8]}{'...' if len(differ) > 8 else ''})")
        want = {n: L if n in fa.LAUNCHES else 0
                for n in clock_a.steps[0]["launches"]}
        every = clock_a.steps + clock_b.steps + clock_c.steps
        run.check(len(every) == 2 * steps and all(
            st["launches"] == want
            and st["dispatch"] == {("nn.sdpa", "library_flash"): L}
            for st in every),
            f"model.fit medium: every step of runs A and B dispatches "
            f"scaled_dot_product_attention to the library op {L} times and "
            f"launches each of its kernels {L} times, no other attention "
            f"kernel (step 1: {every[0]['launches']})")
        run.check(all(map(math.isfinite, losses_a))
                  and losses_a[-1] < losses_a[0],
                  f"model.fit medium: losses finite and falling "
                  f"{losses_a[0]:.4f} -> {losses_a[-1]:.4f}")
        # ---- the costs around the step, on run B's resumed model
        ids = paddle.to_tensor(np.random.RandomState(1).randint(
            0, MEDIUM["vocab_size"], (b, s)))
        loss_fn = _lm_loss(paddle)

        def fwd_bwd():
            loss = loss_fn(net_c(ids), ids)
            loss.backward()
            return loss

        fb_ms = windows_ms(fwd_bwd, reps=1, windows=3)
        loss = fwd_bwd()
        torch.cuda.synchronize()
        guard_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            guard_c.pre_step(loss, opt_c)
            guard_ms.append((time.perf_counter() - t0) * 1e3)
        opt_ms = windows_ms(opt_c.step, reps=1, windows=3)
        opt_c.clear_grad()
        t0 = time.perf_counter()
        for i in range(1000):
            wd.step_begin(i)
            wd.step_end()
        wd_us = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model_c.train_batch([ids], [ids])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        idle = max(0.0, 1 - busy / wall_ms)
        # ---- 13d: a poisoned step leaves the parameters bit-equal
        nan0 = obs.counter("train.nan_steps").value
        model_c._loss = _lm_loss(paddle, nan_at=2)
        model_c.train_batch([ids], [ids])
        before = {k: v.clone() for k, v in _state_bits(
            net_c, opt_c, torch).items() if k.startswith("model.")}
        bad = model_c.train_batch([ids], [ids])[0]
        after = _state_bits(net_c, opt_c, torch)
        same = all(torch.equal(v, after[k]) for k, v in before.items())
        nxt = model_c.train_batch([ids], [ids])[0]
        ticks = obs.counter("train.nan_steps").value - nan0
        run.check(math.isnan(bad) and same,
                  f"model.fit medium 13d: the NaN step ({bad}) left every "
                  f"parameter bit-equal ({len(before)} tensors)")
        run.check(ticks == 1 and guard_c.nan_steps == 1,
                  f"model.fit medium 13d: train.nan_steps ticked once "
                  f"({ticks}), the guard counted {guard_c.nan_steps}")
        run.check(math.isfinite(nxt), f"model.fit medium 13d: the next "
                  f"loss is finite ({nxt:.4f}) and the run went on")
        wd.stop()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = [st["ms"] for st in clock_a.steps[1:]]
    ms = float(np.median(timed))
    tok_s = b * s / (ms / 1e3)
    mfu_gauge = float(np.median([st["mfu"] for st in clock_a.steps[1:]]))
    mfu_clock = tok_s * MEDIUM_FLOPS_PER_TOKEN / PEAK_BF16_FLOPS
    save_s = float(np.median(save_ms)) / 1e3
    library = time_library_at_medium(run, fa, mods, torch)
    phase_s = time.perf_counter() - t_phase
    print(f"model.fit medium (GPT-3 Medium widths, {n_params} parameters, "
          f"bf16 + AdamW multi_precision, B{b} S{s}): losses "
          f"{[round(x, 4) for x in losses_a]}", flush=True)
    print(f"model.fit medium: {ms:.2f} ms/step (host clock around "
          f"train_batch with float(loss), median of steps 2-{steps}, spread "
          f"{max(timed) - min(timed):.2f}), {tok_s:.1f} tokens/s, MFU "
          f"{mfu_gauge:.4f} (train.mfu gauge) / {mfu_clock:.4f} (clock)",
          flush=True)
    print(f"model.fit medium: forward+backward {fb_ms[0]:.2f} ms (spread "
          f"{fb_ms[1]:.2f}), optimizer {opt_ms[0]:.2f} ms (spread "
          f"{opt_ms[1]:.2f}) (device events); StepGuard.pre_step with "
          f"check_grads {np.median(guard_ms):.3f} ms (host, median of 5); "
          f"watchdog arm+disarm {wd_us:.2f} us a step", flush=True)
    print(f"model.fit medium: checkpoint {ck_bytes / 1e9:.3f} GB, save "
          f"{save_s * 1e3:.1f} ms (median of {save_ms}), "
          f"{ck_bytes / 1e9 / save_s:.3f} GB/s, resume load {load_ms:.1f} "
          f"ms; profiled step {wall_ms:.2f} ms wall, {busy:.2f} ms kernel "
          f"time, idle share {idle:.3f}; peak memory {peak_gb:.2f} GB; "
          f"phase {phase_s:.1f} s", flush=True)
    for key, kms, count in rows[:12]:
        print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
    return {
        "losses": losses_a, "ms_per_step": ms,
        "ms_per_step_spread": max(timed) - min(timed),
        "step_ms": [st["ms"] for st in clock_a.steps],
        "tokens_per_s": tok_s, "mfu_gauge": mfu_gauge, "mfu_clock": mfu_clock,
        "fwd_bwd_ms": fb_ms[0], "fwd_bwd_ms_spread": fb_ms[1],
        "optimizer_ms": opt_ms[0], "optimizer_ms_spread": opt_ms[1],
        "pre_step_ms": float(np.median(guard_ms)),
        "watchdog_us_per_step": wd_us, "checkpoint_bytes": ck_bytes,
        "save_ms": save_ms, "save_gb_per_s": ck_bytes / 1e9 / save_s,
        "resume_load_ms": load_ms, "profiled_ms": wall_ms,
        "kernel_ms": busy, "idle_share": idle, "peak_memory_gb": peak_gb,
        "parameters": n_params, "bitwise_resume": not differ
        and np.array(losses_a).tobytes() == np.array(losses_b).tobytes(),
        "library_at_d64_s2048": library, "phase_s": phase_s}


# --------------------------------------------------------------- phase 14
# jit.to_static, jit.save/load and the Predictor on the card. Tolerances:
# f32 compiled against eager on the card, the same arithmetic in another
# order (inductor fuses); bf16 a few of bf16's steps; ResNet-50's losses
# and BatchNorm statistics after 3 steps at lr 0.1.
JIT_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 5e-2)}
# ResNet-50 at lr 0.1: the first step's loss and BatchNorm statistics
# tightly; the loss then leaps from ~3.9 to 15-20 in two steps, where f32
# reductions in another order (inductor's BatchNorm, cuDNN's algorithms)
# put the 2nd loss 0.54 % from eager's and the 3rd 0.006-2.1 % in four
# runs of this phase on an NVIDIA H100 80GB HBM3 at 700 W, as far as
# eager's own 3rd loss moved between runs (20.10-20.20)
JIT_RESNET_TOL = {"loss": 1e-4, "buffers": 1e-4, "later_loss": 5e-2}
ADAM_EPS = 1e-8
JIT_MEDIUM_STEPS = 6
# 14c-d at 4 of MEDIUM's 24 layers: inductor's compile of the 24-layer step
# took 190 s of a 1250 s script on a slow host, the 12-layer one 80 s of a
# 1030 s script with phase 21, and the 8-layer phase 70 s of 1044 s (the
# widths stay)
JIT_MEDIUM_LAYERS = 4
JIT_MEDIUM_LOSS_TOL = 1e-2
PREDICT_BATCHES = (1, 2, 4)
# kernel names of the port's attention (every other attention kernel in a
# profile is not the port's)
PORT_ATTENTION = ("mma_", "simple_attention", "causal_attention",
                  "blocked_flash", "qblock")
FOREIGN_ATTENTION = ("flash", "fmha", "attention", "sdpa", "efficient")


def _adam_err(got, want, shaky, dname, steps=3, lr=1e-3):
    """The worst error of a parameter after AdamW steps, in units of its
    leaf's scale: steady elements against the leaf's scale plus Adam's
    largest total step (a zero-initialised bias is the sum of its steps),
    as test_torch_jit.py holds the CPU's; shaky ones against Adam's
    largest step (and, in bf16, a rounding of the value), scaled so that
    the leaf tolerance passes exactly at that bound."""
    err = np.abs(got.astype(np.float64) - want)
    scale = max(np.abs(want).max(), 1e-30) + steps * lr
    out = float(err[~shaky].max() / scale) if (~shaky).any() else 0.0
    if shaky.any():
        cap = 2 * steps * lr * 1.01 + (2.0 ** -8 * np.abs(want[shaky])
                                       if dname == "bfloat16" else 0.0)
        out = max(out, float((err[shaky] / cap).max())
                  * JIT_TOL[dname][1])
    return out


def _gpt_normal_init(model, seed, torch):
    """GPT-2's initialisation, as models/gpt_hybrid.init_params draws it:
    every matrix N(0, 0.02), the LayerNorms and biases as the Layers made
    them; the step-0 loss is then near ln(vocab)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for _, p in model.named_parameters():
            if p._data.dim() >= 2:
                p._data.copy_(torch.randn(p._data.shape, generator=gen,
                                          device="cuda") * 0.02)


def _launches(mods):
    return {n: c for mod in mods for n, c in mod.LAUNCHES.items()}


def _reset(mods):
    for mod in mods:
        mod.reset_launch_counts()


def _sdpa_nodes(sf):
    """aten scaled_dot_product_* nodes of every graph ``sf`` traced."""
    out = []
    for e in sf._cache.values():
        for spec in e["specs"]:
            for g in spec.jitted._graphs.values():
                out += [str(n.target) for n in g.gm.graph.nodes
                        if "scaled_dot_product" in str(n.target)]
    return out


def _foreign_attention(rows):
    """Profile rows named like an attention kernel that is not the port's
    (inductor's pointwise and reduction kernels are not attention)."""
    return [k for k, _, _ in rows
            if any(f in k.lower() for f in FOREIGN_ATTENTION)
            and not any(p in k for p in PORT_ATTENTION)
            and not k.startswith(("triton_poi", "triton_per", "triton_red"))]


def check_small_jit(run, paddle, GPTConfig, GPTForCausalLM, fa, mods, torch):
    """Phase 14a: small programs on the card. The small Layer GPT's
    to_static AdamW steps against eager steps on the card and on the CPU;
    a value-dependent branch; compiled dropout; the library op's fake
    strides; the Predictor's bucket ladder."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = GPTConfig(**SMALL_LAYER_GPT)
    ids = np.random.RandomState(14).randint(0, cfg.vocab_size, (2, 256))
    paddle.seed(0)
    paddle.set_device("cpu")
    state = {k: v.numpy() for k, v in GPTForCausalLM(cfg).state_dict()
             .items()}
    out = {}
    for dname, (loss_tol, leaf_tol) in JIT_TOL.items():
        runs = {}
        for dev, compiled in (("cpu", False), ("gpu:0", False),
                              ("gpu:0", True)):
            paddle.set_device(dev)
            model = GPTForCausalLM(cfg)
            model.set_state_dict(state)
            if dname == "bfloat16":
                model.bfloat16()
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=model.parameters(),
                                         multi_precision=True)
            t = paddle.to_tensor(ids)

            def step():
                loss = model(t, t)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss
            grads = []

            def eager_step():
                loss = model(t, t)
                loss.backward()
                grads.append({n: p.grad.numpy()
                              for n, p in model.named_parameters()})
                opt.step()
                opt.clear_grad()
                return loss
            fn = paddle.jit.to_static(step, objs=[model, opt]) \
                if compiled else eager_step
            losses, per_call = [], []
            for _ in range(3):
                _reset(mods)
                losses.append(float(fn()))
                per_call.append(_launches(mods))
            runs[(dev, compiled)] = (losses, {
                n: np.array(p.numpy()) for n, p in model.named_parameters()},
                per_call, fn, grads)
        tag = f"jit small layer gpt ({dname}, B2 S256 D64, AdamW)"
        L = cfg.num_layers
        cl, cp, calls, sf, _ = runs[("gpu:0", True)]
        # Adam turns round-off in a gradient near zero (the k bias's is
        # zero exactly) into a whole step: elements whose eager gradient
        # on the card is under its noise (100 eps in f32, 2^-7 of the
        # leaf's largest in bf16), or differs in sign from the CPU's, at
        # some step are held to Adam's largest step (3 lr, plus a bf16
        # rounding of the value)
        gc, gg = runs[("cpu", False)][4], runs[("gpu:0", False)][4]

        def noise(g):
            return (100 * ADAM_EPS if dname == "float32"
                    else 2.0 ** -7 * np.abs(g).max())
        shaky = {n: np.any([(np.abs(b[n]) < noise(b[n]))
                            | (np.sign(a[n]) != np.sign(b[n]))
                            for a, b in zip(gc, gg)], axis=0) for n in cp}
        want = {n: L if n in fa.LAUNCHES else 0 for n in calls[0]}
        run.check(all(c == want for c in calls),
                  f"{tag}: every compiled step launches each library kernel "
                  f"{L} times and no other ({calls})")
        # the two eager runs' own distance: Adam amplifies the order of
        # the f32 (or bf16) arithmetic, which the card, the CPU and
        # inductor each choose; the compiled step is held to the larger of
        # the leaf tolerance and twice that distance
        ep, gp = runs[("cpu", False)][1], runs[("gpu:0", False)][1]
        spread = max(_adam_err(gp[n], ep[n], shaky[n], dname) for n in ep)
        param_tol = max(leaf_tol, 2 * spread)
        for ref in (("gpu:0", False), ("cpu", False)):
            rl, rp = runs[ref][:2]
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, rl))
            param_err = max(_adam_err(cp[n], rp[n], shaky[n], dname)
                            for n in rp)
            where = "eager card" if ref[0] == "gpu:0" else "eager cpu"
            run.check(loss_err <= loss_tol and param_err <= param_tol,
                      f"{tag}: 3 compiled steps against 3 {where} steps: "
                      f"losses {[round(x, 6) for x in cl]} vs "
                      f"{[round(x, 6) for x in rl]} (worst rel "
                      f"{loss_err:.3e}, tolerance {loss_tol}), worst "
                      f"parameter {param_err:.3e} of its scale + 3 lr "
                      f"(tolerance {param_tol:.3e}: the larger of "
                      f"{leaf_tol} and twice the eager card-vs-cpu "
                      f"{spread:.3e}; "
                      f"{sum(int(v.sum()) for v in shaky.values())} of "
                      f"{sum(v.size for v in shaky.values())} elements near "
                      f"a zero or noisy gradient held to Adam's largest "
                      f"step)")
        run.check(sf.report()["signatures"][0]["fallback"] is None
                  and not _sdpa_nodes(sf),
                  f"{tag}: no eager fallback, no aten scaled_dot_product "
                  f"node in the graph")
        out[dname] = {"compiled_losses": cl, "eager_card_losses":
                      runs[("gpu:0", False)][0], "eager_spread": spread,
                      "param_tol": param_tol}
    paddle.set_device("gpu:0")

    # a value-dependent branch compiles to two specializations
    @paddle.jit.to_static
    def branchy(x):
        if (x.mean() > 0):
            return x * 2.0
        return x - 1.0
    pos = paddle.to_tensor(np.ones(4, np.float32))
    outs = [branchy(pos * s).numpy() for s in (1, 1, -1, -1, 1)]
    specs = list(branchy.specializations().values())[0]
    run.check(len(specs) == 2 and np.allclose(outs[1], 2.0)
              and np.allclose(outs[3], -2.0) and np.allclose(outs[4], 2.0),
              f"jit: a value-dependent branch compiles to {len(specs)} "
              f"specializations ({specs}) and answers both branches")

    # compiled dropout: a new mask each call, the same after paddle.seed
    @paddle.jit.to_static
    def drop(x):
        return paddle.nn.functional.dropout(x, 0.5)
    x = paddle.ones([256, 256])
    paddle.seed(5)
    a, b = drop(x).numpy(), drop(x).numpy()
    paddle.seed(5)
    a2, b2 = drop(x).numpy(), drop(x).numpy()
    keep = float((a != 0).mean())
    run.check(not np.array_equal(a, b) and np.array_equal(a, a2)
              and np.array_equal(b, b2) and 0.45 < keep < 0.55
              and set(np.unique(a)) <= {0.0, 2.0},
              f"jit: compiled dropout draws a new mask each call and the "
              f"same ones after paddle.seed (keep share {keep:.4f})")

    # the library op's fake strides equal the CUDA kernel's real ones
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, do = path_inputs(gen, torch.bfloat16, torch, (2, 16, 1024, 64))
    real_o, real_lse = fa.OP(q, k, v, 0.125, True)
    real_b = torch.ops.paddle_tpu_torch.library_flash_bwd(
        q, k, v, real_o, real_lse, do.contiguous(), 0.125, True)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq, fk, fv, fdo = (mode.from_tensor(t) for t in (q, k, v,
                                                         do.contiguous()))
        fake_o, fake_lse = fa.OP(fq, fk, fv, 0.125, True)
        fake_b = torch.ops.paddle_tpu_torch.library_flash_bwd(
            fq, fk, fv, fake_o, fake_lse, fdo, 0.125, True)
    real = [t.stride() for t in (real_o, real_lse, *real_b)]
    fake = [t.stride() for t in (fake_o, fake_lse, *fake_b)]
    run.check(real == fake, f"jit: the library ops' fake strides equal the "
              f"kernels' real ones ({real})")

    # the Predictor's bucket ladder on the small GPT's scoring forward
    from paddle_tpu_torch.inference import Config, create_predictor
    paddle.seed(0)
    net = GPTForCausalLM(cfg)
    net.set_state_dict(state)
    net.eval()
    c = Config()
    c.set_layer(net)
    c.enable_shape_bucketing([1, 2, 4])
    pred = create_predictor(c)
    worst = 0.0
    for bsz in range(1, 8):
        t = paddle.to_tensor(np.random.RandomState(bsz).randint(
            0, cfg.vocab_size, (bsz, 256)))
        got = pred.run([t])[0].numpy()
        with paddle.no_grad():
            want = net(t).numpy()
        worst = max(worst, _leaf_err(got, want))
    stats = pred.get_execution_stats()
    run.check(stats["compiled_graphs"] <= 3 and worst <= JIT_TOL[
        "float32"][1],
              f"jit: create_predictor with buckets [1, 2, 4] serves batches "
              f"1-7 from {stats['compiled_graphs']} compiled graphs, worst "
              f"logit {worst:.3e} of its scale (tolerance "
              f"{JIT_TOL['float32'][1]})")
    out["predictor_graphs"] = stats["compiled_graphs"]
    return out


def _profiled(torch, fn):
    """(wall ms, device rows) of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, _device_rows(prof)


def drive_jit_resnet50(run, paddle, torch):
    """Phase 14b: resnet50_cifar10.py's full mode as the workload writes it,
    to_static(train_step, objs=[model, opt]) compiled with inductor: its
    first 3 steps against 3 eager steps on the same batches from the same
    seed, then 20 timed steps."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import Cifar10, FakeData
    from paddle_tpu_torch.vision.models import resnet50
    paddle.set_device("gpu:0")

    def build():
        paddle.seed(0)
        model = resnet50(num_classes=10)
        opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=model.parameters(),
                                        weight_decay=5e-4)
        lossf = nn.CrossEntropyLoss()
        model.train()

        def train_step(xb, yb):
            loss = lossf(model(xb), yb)
            opt.clear_grad()
            loss.backward()
            opt.step()
            return loss
        return model, opt, train_step

    try:
        ds = Cifar10(mode="train")
    except FileNotFoundError:
        ds = FakeData(size=256, image_shape=(3, 32, 32), num_classes=10)
    np.random.seed(0)
    dl = DataLoader(ds, batch_size=RESNET_BATCH, shuffle=True)
    it = iter(dl)

    def batch():
        nonlocal it
        try:
            return next(it)
        except StopIteration:
            it = iter(dl)
            return next(it)
    first = [batch() for _ in range(3)]
    model_e, _, step_e = build()
    eager = [float(step_e(*first[0]))]
    buffers_e = {n: b.numpy() for n, b in model_e.named_buffers()}
    eager += [float(step_e(xb, yb)) for xb, yb in first[1:]]
    del model_e, step_e
    torch.cuda.empty_cache()
    model, opt, train_step = build()
    step_fn = paddle.jit.to_static(train_step, objs=[model, opt])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    compiled = [float(step_fn(*first[0]))]
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    buffers_c = {n: b.numpy() for n, b in model.named_buffers()}
    compiled += [float(step_fn(xb, yb)) for xb, yb in first[1:]]
    errs = [abs(a - b) / abs(b) for a, b in zip(compiled, eager)]
    buf_err = max(_leaf_err(buffers_c[n], buffers_e[n]) for n in buffers_e
                  if buffers_e[n].dtype.kind == "f")
    tol = JIT_RESNET_TOL
    run.check(errs[0] <= tol["loss"] and max(errs[1:]) <= tol["later_loss"],
              f"jit resnet50: the first 3 compiled losses "
              f"{[round(x, 5) for x in compiled]} against 3 eager steps "
              f"{[round(x, 5) for x in eager]} on the same batches (rel "
              f"{[float('%.3e' % e) for e in errs]}; tolerance "
              f"{tol['loss']} on the first, {tol['later_loss']} on the "
              f"next two)")
    run.check(buf_err <= tol["buffers"],
              f"jit resnet50: the BatchNorm running statistics, threaded as "
              f"state, are {buf_err:.3e} of their scale from the eager "
              f"run's after the first step (tolerance {tol['buffers']})")
    g = next(iter(step_fn._cache.values()))["specs"][0].jitted
    graph = next(iter(g._graphs.values()))
    rows_t = []
    for _ in range(RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xb, yb = batch()
        t1 = time.perf_counter()
        loss = float(step_fn(xb, yb))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows_t.append({"ms": (t2 - t0) * 1e3, "data_ms": (t1 - t0) * 1e3,
                       "loss": loss})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = compiled + [r["loss"] for r in rows_t]
    run.check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"jit resnet50: losses finite and falling, {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
    rep = step_fn.report()["signatures"][0]
    run.check(rep["fallback"] is None and len(rep["specializations"]) == 1,
              f"jit resnet50: one compiled specialization, no eager "
              f"fallback ({rep['fallback']})")
    xb, yb = batch()
    wall_ms, rows = _profiled(torch, lambda: float(step_fn(xb, yb)))
    busy = sum(r[1] for r in rows)
    idle = max(0.0, 1 - busy / wall_ms)
    ms_list = [r["ms"] for r in rows_t]
    ms = float(np.median(ms_list))
    data_ms = float(np.median([r["data_ms"] for r in rows_t]))
    print(f"jit resnet50 (inductor, B{RESNET_BATCH} 32x32 f32): first call "
          f"(trace + compile + step) {compile_s:.1f} s (trace "
          f"{graph.trace_s:.1f} s, {len(graph.gm.graph.nodes)} nodes; "
          f"compile {graph.compile_s:.1f} s); {ms:.2f} ms/step "
          f"(host clock, median of {RESNET_STEPS}, spread "
          f"{max(ms_list) - min(ms_list):.2f}), "
          f"{RESNET_BATCH / (ms / 1e3):.1f} images/s, data wait {data_ms:.2f}"
          f" ms; profiled step {wall_ms:.2f} ms wall, {busy:.2f} ms kernel "
          f"time, idle share {idle:.3f}; peak memory {peak_gb:.2f} GB",
          flush=True)
    for key, kms, count in rows[:8]:
        print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
    return {"compile_s": compile_s, "trace_s": graph.trace_s,
            "backend_compile_s": graph.compile_s,
            "graph_nodes": len(graph.gm.graph.nodes), "ms_per_step": ms,
            "ms_per_step_spread": max(ms_list) - min(ms_list),
            "images_per_s": RESNET_BATCH / (ms / 1e3), "data_ms": data_ms,
            "losses": losses, "eager_losses": eager,
            "loss_rel_err": errs, "buffer_err": buf_err,
            "profiled_ms": wall_ms, "kernel_ms": busy, "idle_share": idle,
            "peak_memory_gb": peak_gb}


def drive_jit_medium(run, paddle, fa, mods, torch, eager_ms=None):
    """Phase 14c: GPT-3 Medium's widths as the Layer GPT (phase 13's
    MEDIUM at JIT_MEDIUM_LAYERS layers), bf16, AdamW(1e-4,
    multi_precision), B4 S2048, its train step compiled with
    to_static(objs=[model, opt]) and inductor."""
    from paddle_tpu_torch.cost_model.cost_model import gpt_flops_per_token
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(**dict(MEDIUM, num_layers=JIT_MEDIUM_LAYERS))
    b, s, L = MEDIUM_BATCH, MEDIUM_SEQ, cfg.num_layers
    paddle.set_device("gpu:0")
    paddle.seed(0)
    model = GPTForCausalLM(cfg)
    _gpt_normal_init(model, 14, torch)
    model.bfloat16()
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    n_params = sum(p._data.numel() for p in model.parameters())
    ids = paddle.to_tensor(np.random.RandomState(14).randint(
        0, cfg.vocab_size, (b, s)))
    with paddle.no_grad():
        eager_loss = float(model(ids, ids))

    def step(x):
        loss = model(x, x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    step_fn = paddle.jit.to_static(step, objs=[model, opt])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step, ticks = [], [], [], []
    compile_s = None
    for i in range(JIT_MEDIUM_STEPS):
        _reset(mods)
        ticks0 = fa.dispatch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step_fn(ids))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if i == 0:
            compile_s = dt / 1e3
        times.append(dt)
        per_step.append(_launches(mods))
        ticks.append(fa.dispatch_counts(ticks0))
        losses.append(loss)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {n: L if n in fa.LAUNCHES else 0 for n in per_step[0]}
    run.check(all(p == want for p in per_step),
              f"jit medium: every compiled step launches library_flash_fwd, "
              f"_bwd_dq and _bwd_dkv {L} times each and no other attention "
              f"kernel ({per_step[0]})")
    run.check(ticks[0] == {("nn.sdpa", "library_flash"): L}
              and all(t == {} for t in ticks[1:]),
              f"jit medium: nn.sdpa{{library_flash}} ticks {L} times while "
              f"the step is traced and never from the compiled program "
              f"({ticks})")
    run.check(not _sdpa_nodes(step_fn),
              "jit medium: no aten scaled_dot_product node in the traced "
              "graph")
    rel = abs(losses[0] - eager_loss) / abs(eager_loss)
    run.check(10 <= losses[0] <= 11.5 and rel <= JIT_MEDIUM_LOSS_TOL,
              f"jit medium: step-0 loss {losses[0]:.4f} in [10, 11.5], "
              f"{rel:.3e} from the eager forward's {eager_loss:.4f} "
              f"(tolerance rel {JIT_MEDIUM_LOSS_TOL})")
    run.check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"jit medium: losses finite and falling "
              f"{[round(x, 4) for x in losses]}")
    wall_ms, rows = _profiled(torch, lambda: float(step_fn(ids)))
    busy = sum(r[1] for r in rows)
    idle = max(0.0, 1 - busy / wall_ms)
    foreign = _foreign_attention(rows)
    run.check(not foreign, f"jit medium: the profile holds no attention "
              f"kernel but the port's ({foreign})")
    timed = times[1:]
    ms = float(np.median(timed))
    tok_s = b * s / (ms / 1e3)
    mfu = tok_s * gpt_flops_per_token(cfg, s) / PEAK_BF16_FLOPS
    g = next(iter(step_fn._cache.values()))["specs"][0].jitted
    graph = next(iter(g._graphs.values()))
    print(f"jit medium (GPT-3 Medium widths at {L} of "
          f"{MEDIUM['num_layers']} layers, {n_params} parameters, bf16 + "
          f"AdamW multi_precision, B{b} S{s}, inductor): first call (trace "
          f"+ compile + step) {compile_s:.1f} s (trace {graph.trace_s:.1f} "
          f"s, {len(graph.gm.graph.nodes)} nodes; compile "
          f"{graph.compile_s:.1f} s); {ms:.2f} ms/step (host "
          f"clock with float(loss), median of steps 2-{JIT_MEDIUM_STEPS}, "
          f"spread {max(timed) - min(timed):.2f}), {tok_s:.1f} tokens/s, "
          f"MFU {mfu:.4f}; eager Model.fit (phase 13b, all layers) "
          f"{eager_ms if eager_ms is None else round(eager_ms, 2)} ms/step; "
          f"profiled step {wall_ms:.2f} ms wall, {busy:.2f} ms kernel time, "
          f"idle share {idle:.3f}; peak memory {peak_gb:.2f} GB", flush=True)
    for key, kms, count in rows[:12]:
        print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
    return model, cfg, {
        "compile_s": compile_s, "trace_s": graph.trace_s,
        "backend_compile_s": graph.compile_s,
        "graph_nodes": len(graph.gm.graph.nodes),
        "losses": losses, "eager_loss": eager_loss,
        "ms_per_step": ms, "ms_per_step_spread": max(timed) - min(timed),
        "tokens_per_s": tok_s, "mfu": mfu, "eager_fit_ms_per_step": eager_ms,
        "profiled_ms": wall_ms, "kernel_ms": busy, "idle_share": idle,
        "peak_memory_gb": peak_gb, "parameters": n_params, "layers": L,
        "launches_per_step": per_step[-1]}


def drive_jit_predictor(run, paddle, fa, mods, torch, model, cfg, root):
    """Phase 14d: jit.save of 14c's GPT-3 Medium-width eval scoring forward
    with a dynamic batch, served through create_predictor at B1, B2 and
    B4."""
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.jit import InputSpec
    s, L = MEDIUM_SEQ, cfg.num_layers
    model.eval()
    path = os.path.join(root, "gpt_medium")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paddle.jit.save(model, path, input_spec=[InputSpec([None, s], "int64")])
    save_s = time.perf_counter() - t0
    size_gb = os.path.getsize(path + ".pdmodel") / 1e9
    t0 = time.perf_counter()
    pred = create_predictor(Config(path))
    load_s = time.perf_counter() - t0
    tol = JIT_TOL["bfloat16"][1]
    rows = {}
    for bsz in PREDICT_BATCHES:
        t = paddle.to_tensor(np.random.RandomState(bsz).randint(
            0, cfg.vocab_size, (bsz, s)))
        with paddle.no_grad():
            want = model(t)._data.float()
        pred.run([t])                       # first run of this batch
        _reset(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pred.run([t])[0]._data.float()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launches(mods)
        err = float((got - want).abs().max() / want.abs().max())
        rows[bsz] = {"ms": ms, "err": err, "launches": launches}
        run.check(launches == {n: L if n == "library_flash_fwd" else 0
                               for n in launches} and err <= tol,
                  f"jit predictor B{bsz}: the exported program launches "
                  f"library_flash_fwd {L} times and no other attention "
                  f"kernel ({launches}); logits {err:.3e} of their scale "
                  f"from the eager forward's (tolerance {tol})")
    programs = 1 if pred._compiled is pred._layer else None
    run.check(programs == 1, f"jit predictor: one exported program "
              f"serves B{PREDICT_BATCHES}")
    print(f"jit predictor (GPT-3 Medium scoring forward, torch.export, "
          f"batch dynamic): file {size_gb:.3f} GB, save {save_s:.1f} s, "
          f"load {load_s:.1f} s; ms per run "
          f"{ {b: round(r['ms'], 2) for b, r in rows.items()} }", flush=True)
    model.train()
    return {"file_gb": size_gb, "save_s": save_s, "load_s": load_s,
            "runs": {str(b): r["ms"] for b, r in rows.items()},
            "logit_err": {str(b): r["err"] for b, r in rows.items()}}


def drive_jit(run, paddle, fa, mods, torch, eager_fit_ms, cache_root):
    """Phase 14: every count zeroed before each part and read after it."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    out["small"] = check_small_jit(run, paddle, GPTConfig, GPTForCausalLM,
                                   fa, mods, torch)
    out["small"]["phase_s"] = time.perf_counter() - t0
    print(f"jit small phase: {out['small']['phase_s']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["resnet50"] = drive_jit_resnet50(run, paddle, torch)
    out["resnet50"]["phase_s"] = time.perf_counter() - t0
    print(f"jit resnet50 phase: {out['resnet50']['phase_s']:.1f} s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, cfg, out["medium"] = drive_jit_medium(run, paddle, fa, mods,
                                                 torch, eager_fit_ms)
    out["medium"]["phase_s"] = time.perf_counter() - t0
    print(f"jit medium phase: {out['medium']['phase_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=cache_root) as root:
        out["predictor"] = drive_jit_predictor(run, paddle, fa, mods, torch,
                                               model, cfg, root)
    out["predictor"]["phase_s"] = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_14_s"] = time.perf_counter() - t_phase
    print(f"jit phase: {out['phase_14_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 15
# GPT-1.3B through paddle._C_ops (the flagship's widths, B4 S1024, bf16)
CAPI_STEPS, CAPI_LR = 3, 5e-5
FLOP_PER_TOKEN_1P3B = 8.4863e9          # gpt_flops_per_token, 1.3B at S1024
# The PTB "large" LSTM LM (Zaremba, Sutskever & Vinyals 2014, section 4.1;
# PaddlePaddle/models ptb_lm "large"): vocab 10000, 2 layers of 1500,
# dropout 0.65 on the non-recurrent connections, uniform init in +-0.04,
# SGD at lr 1 with global-norm clipping at 10, B20, 35 steps unrolled.
PTB_LARGE = dict(vocab=10000, hidden=1500, layers=2, dropout=0.65,
                 init=0.04, batch=20, steps=35, lr=1.0, clip=10.0)
PTB_SMALL = dict(PTB_LARGE, vocab=50, hidden=32, dropout=0.0, batch=4,
                 steps=8)
PTB_TRAIN_STEPS = 10


def _arr(shape, seed, lo=None, hi=None, dtype=np.float32):
    r = np.random.RandomState(seed)
    if lo is None:
        return r.randn(*shape).astype(dtype)
    return r.uniform(lo, hi, shape).astype(dtype)


def _ints(shape, hi, seed=0):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(np.int64)


def _quantized_linear(p, a, w):
    q, s = p.nn.quant.weight_quantize(w)
    return q, s, p.nn.quant.weight_only_linear(a, q, weight_scale=s)


def card_cases():
    """(name, fn(paddle, *tensors), numpy inputs): every function this
    slice adds, on one small input (phase 15a runs each on the card and on
    the CPU)."""
    x34, pos, prob = _arr((3, 4), 0), _arr((3, 4), 1, 0.5, 3.0), \
        _arr((3, 4), 2, 0.05, 0.95)
    img = _arr((2, 3, 6, 6), 3)
    grid = _arr((2, 4, 5, 2), 4, -1.2, 1.2)
    lab = (_arr((3, 4), 5) > 0).astype(np.float32)
    seg = np.array([0, 0, 1, 1, 1, 3])
    src, dst = np.array([0, 1, 2, 3, 4, 0]), np.array([1, 1, 0, 3, 0, 1])

    def X(p):
        return p.ops.extra

    def V(p):
        import importlib
        return importlib.import_module(p.__name__ + ".ops.vision_ops")

    def F(p):
        return p.nn.functional
    cases = [
        ("p_norm", lambda p, a: X(p).p_norm(a, 3.0, 1), [x34]),
        ("frobenius_norm", lambda p, a: X(p).frobenius_norm(a, [0, 1]),
         [x34]),
        ("squared_l2_norm", lambda p, a: X(p).squared_l2_norm(a), [x34]),
        ("clip_by_norm", lambda p, a: X(p).clip_by_norm(a, 1.0), [x34]),
        ("renorm", lambda p, a: p.renorm(a, 2.0, 0, 1.0), [x34]),
        ("gammaln", lambda p, a: p.gammaln(a), [pos]),
        ("polygamma", lambda p, a: p.polygamma(a, 2), [pos]),
        ("gammainc", lambda p, a, b: p.gammainc(a, b), [pos, prob]),
        ("gammaincc", lambda p, a, b: p.gammaincc(a, b), [pos, prob]),
        ("logsigmoid", lambda p, a: X(p).logsigmoid(a), [x34]),
        ("tanh_shrink", lambda p, a: X(p).tanh_shrink(a), [x34]),
        ("swiglu", lambda p, a: X(p).swiglu(a), [x34]),
        ("fill", lambda p, a: X(p).fill(a, 2.0), [x34]),
        ("fill_diagonal", lambda p, a: X(p).fill_diagonal(a, 9.0, 1),
         [x34]),
        ("reverse", lambda p, a: p.reverse(a, [0, 1]), [x34]),
        ("shape", lambda p, a: p.shape(a), [img]),
        ("as_strided", lambda p, a: p.as_strided(a, [3, 2], [2, 3], 1),
         [x34]),
        ("tensor_unfold", lambda p, a: X(p).tensor_unfold(a, 1, 2, 1),
         [x34]),
        ("view_dtype", lambda p, a: X(p).view_dtype(a, "int32"), [x34]),
        ("view_shape", lambda p, a: X(p).view_shape(a, [4, 3]), [x34]),
        ("split_with_num", lambda p, a: X(p).split_with_num(a, 2, 1),
         [x34]),
        ("reduce_as", lambda p, a, t: p.reduce_as(a, t),
         [_arr((2, 3, 4), 6), _arr((3, 1), 7)]),
        ("bce_loss", lambda p, a, y: X(p).bce_loss(a, y), [prob, lab]),
        ("hinge_loss", lambda p, a, y: X(p).hinge_loss(a, y), [x34, lab]),
        ("kldiv_loss", lambda p, a, y: X(p).kldiv_loss(a, y, "batchmean"),
         [x34, prob]),
        ("sigmoid_ce_logits", lambda p, a, y: X(p)
         .sigmoid_cross_entropy_with_logits(a, y, True), [x34, lab]),
        ("margin_cross_entropy", lambda p, a, y: X(p).margin_cross_entropy(
            a, y, return_softmax=True),
         [_arr((4, 6), 8, -0.9, 0.9), _ints((4,), 6)]),
        ("fused_softmax_mask", lambda p, a, m: X(p).fused_softmax_mask(a, m),
         [_arr((2, 2, 4, 4), 9), _arr((2, 1, 4, 4), 10)]),
        ("fused_softmax_mask_upper_triangle", lambda p, a: X(p)
         .fused_softmax_mask_upper_triangle(a), [_arr((2, 2, 4, 4), 9)]),
        ("edit_distance", lambda p, h, r, hl, rl: X(p).edit_distance(
            h, r, hl, rl, True), [_ints((3, 5), 4), _ints((3, 6), 4, 1),
                                  np.array([5, 3, 1]), np.array([6, 2, 4])]),
        ("viterbi_decode", lambda p, e, t, n: X(p).viterbi_decode(e, t, n),
         [_arr((2, 5, 3), 11), _arr((5, 5), 12), np.array([5, 3])]),
        ("gather_tree", lambda p, i, q: X(p).gather_tree(i, q),
         [_ints((4, 2, 3), 9), _ints((4, 2, 3), 3, 1)]),
        ("send_u_recv", lambda p, a, s, d: X(p).send_u_recv(a, s, d, "MAX"),
         [_arr((5, 3), 13), src, dst]),
        ("segment_pool", lambda p, a, s: X(p).segment_pool(a, s, "MEAN"),
         [_arr((6, 3), 14), seg]),
        ("bilinear_interp", lambda p, a: V(p).bilinear_interp(a, 9, 4),
         [img]),
        ("nearest_interp", lambda p, a: V(p).nearest_interp(a, 9, 4), [img]),
        ("bicubic_interp", lambda p, a: V(p).bicubic_interp(a, 9, 4), [img]),
        ("linear_interp", lambda p, a: V(p).linear_interp(a, 9),
         [_arr((2, 3, 6), 15)]),
        ("trilinear_interp", lambda p, a: V(p).trilinear_interp(a, 3, 5, 4),
         [_arr((1, 2, 2, 3, 3), 16)]),
        ("affine_grid", lambda p, t: V(p).affine_grid(t, [2, 3, 4, 5]),
         [_arr((2, 2, 3), 17)]),
        ("grid_sample", lambda p, a, g: V(p).grid_sample(
            a, g, padding_mode="reflection"), [img, grid]),
        ("pad3d", lambda p, a: V(p).pad3d(a, [1, 2, 0, 1, 2, 1], "reflect"),
         [_arr((1, 2, 3, 4, 4), 18)]),
        ("pool2d", lambda p, a: V(p).pool2d(a, 3, 2, 1, "avg"), [img]),
        ("pool3d", lambda p, a: V(p).pool3d(a, 2, 2, 1),
         [_arr((1, 2, 4, 4, 4), 19)]),
        ("max_pool2d_with_index", lambda p, a: V(p).max_pool2d_with_index(
            a, 3, 2, 1), [img]),
        ("unpool", lambda p, a: V(p).unpool(*V(p).max_pool2d_with_index(
            a, 2), 2), [img]),
        ("temporal_shift", lambda p, a: V(p).temporal_shift(a, 2),
         [_arr((4, 8, 2, 2), 20)]),
        ("shuffle_channel", lambda p, a: V(p).shuffle_channel(a, 3),
         [_arr((2, 6, 2, 2), 21)]),
        ("frame", lambda p, a: p.signal.frame(a, 4, 2), [_arr((2, 10), 22)]),
        ("overlap_add", lambda p, a: p.signal.overlap_add(a, 2),
         [_arr((2, 4, 3), 23)]),
        ("stft", lambda p, a: p.signal.stft(a, 8, 2).abs(),
         [_arr((2, 32), 24)]),
        ("istft", lambda p, a: p.signal.istft(p.signal.stft(a, 8, 2), 8, 2),
         [_arr((2, 32), 24)]),
        ("block_diag", lambda p, a, b: p.block_diag([a, b]), [x34, pos]),
        ("cartesian_prod", lambda p, a, b: p.cartesian_prod([a, b]),
         [_arr((3,), 25), _arr((2,), 26)]),
        ("combinations", lambda p, a: p.combinations(a, 2),
         [_arr((4,), 27)]),
        ("vander", lambda p, a: p.vander(a, 4), [_arr((3,), 28)]),
        ("column_stack", lambda p, a, b: p.column_stack([a, b]), [x34, pos]),
        ("row_stack", lambda p, a, b: p.row_stack([a, b]), [x34, pos]),
        ("hsplit", lambda p, a: p.hsplit(a, [1, 3]), [x34]),
        ("vsplit", lambda p, a: p.vsplit(a, [1]), [x34]),
        ("dsplit", lambda p, a: p.dsplit(a, 2), [_arr((2, 2, 4), 29)]),
        ("unflatten", lambda p, a: p.unflatten(a, 1, [2, 2]), [x34]),
        ("add_n", lambda p, a, b: p.add_n([a, b, a]), [x34, pos]),
        ("slice_scatter", lambda p, a, v: p.slice_scatter(
            a, v, [1], [0], [4], [2]), [x34, _arr((3, 2), 30)]),
        ("select_scatter", lambda p, a, v: p.select_scatter(a, v, 0, 1),
         [x34, _arr((4,), 31)]),
        ("diagonal_scatter", lambda p, a, v: p.diagonal_scatter(a, v, 1),
         [x34, _arr((3,), 32)]),
        ("isin", lambda p, a, t: p.isin(a, t),
         [_ints((3, 4), 6), np.array([1, 4])]),
        ("histogram_bin_edges", lambda p, a: p.histogram_bin_edges(a, 5),
         [x34]),
        ("pdist", lambda p, a: p.pdist(a), [x34]),
        ("sinc", lambda p, a: p.sinc(a), [x34]),
        ("sgn", lambda p, a: p.sgn(a), [x34]),
        ("signbit", lambda p, a: p.signbit(a), [x34]),
        ("frexp", lambda p, a: p.frexp(a), [x34]),
        ("ldexp", lambda p, a, e: p.ldexp(a, e), [x34, _ints((3, 4), 4)]),
        ("trapezoid", lambda p, a: p.trapezoid(a, dx=0.5), [x34]),
        ("cumulative_trapezoid", lambda p, a: p.cumulative_trapezoid(a),
         [x34]),
        ("multigammaln", lambda p, a: p.multigammaln(a, 3),
         [_arr((3, 4), 33, 2.0, 5.0)]),
        ("rank", lambda p, a: p.rank(a), [img]),
        ("segment_sum", lambda p, a, s: p.geometric.segment_sum(a, s),
         [_arr((6, 3), 14), seg]),
        ("segment_max", lambda p, a, s: p.geometric.segment_max(a, s),
         [_arr((6, 3), 14), seg]),
        ("geometric.send_ue_recv", lambda p, a, e, s, d: p.geometric
         .send_ue_recv(a, e, s, d, "mul", "mean"),
         [_arr((5, 3), 13), _arr((6, 3), 34), src, dst]),
        ("geometric.send_uv", lambda p, a, b, s, d: p.geometric.send_uv(
            a, b, s, d), [_arr((5, 3), 13), _arr((5, 3), 35), src[:3],
                          dst[:3]]),
        ("pairwise_distance", lambda p, a, b: F(p).pairwise_distance(a, b),
         [x34, pos]),
        ("poisson_nll_loss", lambda p, a, y: F(p).poisson_nll_loss(a, y),
         [x34, pos]),
        ("gaussian_nll_loss", lambda p, a, y, v: F(p).gaussian_nll_loss(
            a, y, v), [x34, prob, pos]),
        ("multi_margin_loss", lambda p, a, y: F(p).multi_margin_loss(a, y),
         [x34, _ints((3,), 4)]),
        ("triplet_margin_with_distance_loss", lambda p, a, b, c: F(p)
         .triplet_margin_with_distance_loss(a, b, c), [x34, pos, prob]),
        ("hsigmoid_loss", lambda p, a, y, w: F(p).hsigmoid_loss(a, y, 6, w),
         [_arr((4, 3), 36), _ints((4,), 6), _arr((5, 3), 37)]),
        ("rnnt_loss", lambda p, a, y, il, ll: F(p).rnnt_loss(a, y, il, ll),
         [_arr((2, 4, 3, 5), 38), np.array([[1, 2], [3, 1]]),
          np.array([4, 3]), np.array([2, 1])]),
        ("adaptive_log_softmax_with_loss", lambda p, a, y, h, t0, t1: F(p)
         .adaptive_log_softmax_with_loss(a, y, h, [t0, t1], [4, 7, 10]),
         [_arr((5, 3), 39), np.array([0, 5, 9, 3, 6]), _arr((3, 6), 40),
          _arr((3, 3), 41), _arr((3, 3), 42)]),
        ("zeropad2d", lambda p, a: F(p).zeropad2d(a, [1, 2, 0, 1]), [img]),
        ("max_unpool2d", lambda p, a: F(p).max_unpool2d(
            *F(p).max_pool2d(a, 2, return_mask=True), 2), [img]),
        ("fractional_max_pool2d", lambda p, a: F(p).fractional_max_pool2d(
            a, 4, random_u=0.3), [img]),
        ("affine_grid_3d", lambda p, t: F(p).affine_grid(t, [1, 2, 3, 4, 5]),
         [_arr((1, 3, 4), 43)]),
        ("functional.grid_sample", lambda p, a, g: F(p).grid_sample(a, g),
         [img, grid]),
        ("sparse_attention", lambda p, q, k, v, o, c: F(p).sparse_attention(
            q, k, v, o, c), [_arr((1, 2, 4, 8), 44), _arr((1, 2, 4, 8), 45),
                             _arr((1, 2, 4, 8), 46),
                             np.tile(np.array([0, 2, 3, 6, 7]), (1, 2, 1)),
                             np.tile(np.array([0, 1, 1, 0, 2, 3, 3]),
                                     (1, 2, 1))]),
        ("flashmask_attention", lambda p, q, k, v: F(p).flashmask_attention(
            q, k, v, causal=True), [_arr((1, 6, 2, 8), 47),
                                    _arr((1, 6, 2, 8), 48),
                                    _arr((1, 6, 2, 8), 49)]),
        ("weight_only_linear", _quantized_linear,
         [_arr((4, 16), 50), _arr((16, 8), 51)]),
    ]
    return cases


def _np_outs(out):
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [np.asarray(o.numpy()) for o in outs if o is not None]


def check_c_ops_surface(run, paddle, torch):
    """Phase 15a: the _C_ops surface, the slice's functions on the card
    against the CPU, the explicit infermeta functions against the real
    outputs, and nn.quant's weight-only linear at Llama-2-7B's MLP
    width."""
    import importlib
    import inspect
    import re
    from paddle_tpu_torch import _C_ops as C
    from paddle_tpu_torch.core import infermeta as im
    out = {}
    src = open(C.__file__).read()
    paths = sorted(set(re.findall(r"_bind\('([^']+)'\)", src)))
    missing = []
    for path in paths:
        mod, fn = path.rsplit(".", 1)
        obj = getattr(importlib.import_module(mod), fn, None)
        if not callable(obj) or not obj.__module__.startswith(
                "paddle_tpu_torch") \
                or "NotImplementedError" in inspect.getsource(obj):
            missing.append(path)
    unbound = [n for n in C.__all__ if not callable(getattr(C, n, None))]
    out["bindings"], out["names"] = len(paths), len(C.__all__)
    run.check(len(paths) == 461 and not missing and not unbound,
              f"_C_ops: {len(paths)} bindings (461) and {len(C.__all__)} "
              f"names resolve to callables of the port, none raising "
              f"NotImplementedError; missing {missing}, unbound {unbound}")

    disagree, errs = [], {}
    cases = card_cases()
    for name, fn, inputs in cases:
        got = {}
        for dev in ("cpu", "gpu:0"):
            paddle.set_device(dev)
            paddle.seed(0)
            got[dev] = _np_outs(fn(paddle, *[paddle.to_tensor(a)
                                             for a in inputs]))
        worst = 0.0
        ok = len(got["cpu"]) == len(got["gpu:0"])
        for g, w in zip(got["gpu:0"], got["cpu"]):
            ok = ok and g.shape == w.shape and g.dtype == w.dtype
            if not ok:
                break
            g64, w64 = g.astype(np.float64), w.astype(np.float64)
            fin = np.isfinite(w64)
            # an empty segment's max is -inf on both: equal where not finite
            ok = ok and np.array_equal(fin, np.isfinite(g64)) \
                and np.array_equal(g64[~fin], w64[~fin])
            if fin.any():
                scale = max(float(np.max(np.abs(w64[fin]))), 1e-30)
                worst = max(worst, float(np.max(np.abs(g64[fin] - w64[fin])))
                            / scale)
        errs[name] = worst
        if not ok or worst > 1e-5:
            disagree.append((name, worst))
    out["card_cpu_cases"] = len(cases)
    out["card_cpu_worst_rel"] = max(errs.values())
    run.check(not disagree,
              f"15a: {len(cases)} functions of this slice on the card equal "
              f"the CPU's (f32, 1e-5 of each output's scale; worst "
              f"{max(errs.values()):.3e}); disagreeing: {disagree}")

    # the draws: on the card, their support and first moments
    paddle.set_device("gpu:0")
    paddle.seed(1)
    g = paddle.standard_gamma(paddle.full([200000], 3.0)).numpy()
    d = paddle.ops.extra.dirichlet(paddle.full([100000, 3], 2.0)).numpy()
    v, ids = paddle.ops.extra.top_p_sampling(
        paddle.to_tensor(np.tile(np.array([[0.5, 0.3, 0.15, 0.05]],
                                          np.float32), (20000, 1))),
        paddle.full([20000], 0.7))
    ids = ids.numpy().reshape(-1)
    run.check((g > 0).all() and abs(g.mean() - 3.0) < 0.05
              and (d > 0).all() and np.allclose(d.sum(-1), 1.0, atol=1e-5)
              and abs(d.mean() - 1 / 3) < 0.01
              and set(np.unique(ids)) == {0, 1},
              f"15a: draws on the card: standard_gamma(3) mean "
              f"{g.mean():.4f}, dirichlet(2,2,2) rows sum to 1 with mean "
              f"{d.mean():.4f}, top_p(0.7) draws ids {sorted(set(ids))}")

    # the card's generator state: a restore repeats the draws after it
    paddle.seed(3)
    states = paddle.get_cuda_rng_state()
    first = paddle.rand([1000]).numpy()
    paddle.set_cuda_rng_state(states)
    again = paddle.rand([1000]).numpy()
    run.check(len(states) == torch.cuda.device_count()
              and np.array_equal(first, again),
              f"15a: get_cuda_rng_state gives {len(states)} card state(s); "
              "set_cuda_rng_state repeats the draws made after it")

    # the AMP and optimizer ops stay on the card
    grads = [paddle.to_tensor(np.array([1024.0, np.inf], np.float32))]
    _, found = paddle.ops.extra.check_finite_and_unscale_(
        grads, paddle.to_tensor(np.float32(1024.0)))
    scale = paddle.to_tensor(np.float32(1024.0))
    good, bad = (paddle.to_tensor(np.int32(0)) for _ in range(2))
    paddle.ops.extra.update_loss_scaling_(grads, found, scale, good, bad)
    run.check(found._data.is_cuda and scale._data.is_cuda
              and bool(found.numpy()[0]) and float(scale.numpy()) == 512.0
              and float(grads[0].numpy().max()) == 0.0,
              "15a: check_finite_and_unscale_/update_loss_scaling_ keep "
              "found_inf and the scale on the card, halve the scale and "
              "zero the grads on an inf")

    # each explicit infermeta against the real output on the card
    M = im.MetaTensor
    explicit = [
        ("reshape", [(2, 3, 4)], {"shape": [-1, 4]},
         lambda m: im.reshape_infermeta(m[0], [-1, 4])),
        ("transpose", [(2, 3, 4)], {"perm": [2, 0, 1]},
         lambda m: im.transpose_infermeta(m[0], [2, 0, 1])),
        ("flatten", [(2, 3, 4)], {"start_axis": 1},
         lambda m: im.flatten_infermeta(m[0], 1)),
        ("squeeze", [(2, 1, 4)], {"axis": 1},
         lambda m: im.squeeze_infermeta(m[0], 1)),
        ("unsqueeze", [(2, 4)], {"axis": [0, 2]},
         lambda m: im.unsqueeze_infermeta(m[0], [0, 2])),
        ("expand", [(1, 3)], {"shape": [5, -1]},
         lambda m: im.expand_infermeta(m[0], [5, -1])),
        ("tile", [(2, 3)], {"repeat_times": [2, 1, 2]},
         lambda m: im.tile_infermeta(m[0], [2, 1, 2])),
        ("matmul", [(5, 2, 3), (3, 4)], {},
         lambda m: im.matmul_infermeta(m[0], m[1])),
        ("addmm", [(3, 4), (3, 5), (5, 4)], {},
         lambda m: im.addmm_infermeta(*m)),
        ("concat", [(2, 3), (4, 3)], None,
         lambda m: im.concat_infermeta(m, 0)),
        ("stack", [(2, 3), (2, 3)], None,
         lambda m: im.stack_infermeta(m, 1)),
        ("split", [(6, 3)], {"num_or_sections": [1, 2, 3]},
         lambda m: im.split_infermeta(m[0], [1, 2, 3])),
        ("conv2d", [(2, 3, 16, 16), (8, 3, 3, 3)],
         {"stride": 2, "padding": 1},
         lambda m: im.conv2d_infermeta(m[0], m[1], 2, 1)),
        ("pool2d", [(2, 3, 16, 16)], {"kernel_size": 2},
         lambda m: im.pool2d_infermeta(m[0], 2)),
        ("softmax", [(2, 3)], {"axis": 0},
         lambda m: im.softmax_infermeta(m[0], 0)),
        ("layer_norm", [(2, 3, 4)], {"normalized_shape": [4]},
         lambda m: im.layer_norm_infermeta(m[0])),
        ("tril", [(3, 4)], {"diagonal": 1},
         lambda m: im.tril_triu_infermeta(m[0], 1)),
        ("triu", [(3, 4)], {}, lambda m: im.tril_triu_infermeta(m[0])),
        ("cast", [(2, 3)], {"dtype": "bfloat16"},
         lambda m: im.cast_infermeta(m[0], "bfloat16")),
        ("where", [(2, 1), (2, 3), (3,)], {},
         lambda m: im.where_infermeta(*m)),
    ]
    kernels = {"pool2d": paddle.nn.functional.max_pool2d,
               "softmax": paddle.nn.functional.softmax,
               "layer_norm": paddle.nn.functional.layer_norm,
               "conv2d": paddle.nn.functional.conv2d,
               "concat": lambda *xs: paddle.concat(list(xs), 0),
               "stack": lambda *xs: paddle.stack(list(xs), 1)}
    wrong = []
    for name, shapes, kw, meta in explicit:
        xs = [paddle.to_tensor(np.ones(s, np.float32) if not (
            name == "where" and i == 0) else np.ones(s, bool))
            for i, s in enumerate(shapes)]
        op = kernels.get(name) or getattr(paddle, name)
        res = op(*xs, **(kw or {}))
        res = res if isinstance(res, (list, tuple)) else [res]
        want = meta([M(x.shape, x.dtype) for x in xs])
        want = want if isinstance(want, list) else [want]
        got = [M(r.shape, r.dtype) for r in res]
        if got != want or not all(r._data.is_cuda for r in res):
            wrong.append((name, got, want))
    out["infermeta_checked"] = len(explicit)
    run.check(not wrong, f"15a: {len(explicit)} explicit infermeta "
              f"functions equal the shape and dtype of the op's output on "
              f"the card; wrong: {wrong}")

    # nn.quant at Llama-2-7B's MLP width: x [8, 4096] bf16, w [4096, 11008]
    paddle.seed(2)
    w = paddle.randn([4096, 11008]) * 0.02
    x = paddle.randn([8, 4096]).astype("bfloat16")
    q, s = paddle.nn.quant.weight_quantize(w)
    wd = paddle.nn.quant.weight_dequantize(q, s, out_dtype="bfloat16")
    got = paddle.nn.quant.weight_only_linear(x, q, weight_scale=s)
    want = paddle.matmul(x, wd)
    a, r = max_err(got._data, want._data)
    run.check(q.dtype == paddle.int8 and r <= 2e-2,
              f"15a: weight_only_linear (int8 [4096, 11008], x [8, 4096] "
              f"bf16) against weight_dequantize + bf16 matmul: max abs err "
              f"{a:.3e}, {r:.3e} of the scale (tolerance 2e-2)")
    wol_ms, wol_spread = windows_ms(
        lambda: paddle.nn.quant.weight_only_linear(x, q, weight_scale=s),
        reps=20)
    mm_ms, mm_spread = windows_ms(lambda: paddle.matmul(x, wd), reps=20)
    print(f"15a: weight_only_linear {wol_ms:.4f} ms (spread "
          f"{wol_spread:.4f}) beside the bf16 matmul {mm_ms:.4f} ms (spread "
          f"{mm_spread:.4f}) at x [8, 4096] w [4096, 11008]", flush=True)
    out["weight_only_linear_ms"], out["bf16_matmul_ms"] = wol_ms, mm_ms
    out["weight_only_linear_ms_spread"] = wol_spread
    out["bf16_matmul_ms_spread"] = mm_spread
    out["weight_only_linear_rel_err"] = r

    # the host cost of one _C_ops call beside one eager-op call
    t1, t2 = paddle.ones([4, 4]), paddle.ones([4, 4])
    n = 2000
    for label, op in (("c_ops", C.add), ("eager", paddle.add)):
        op(t1, t2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            op(t1, t2)
        out[f"{label}_call_host_us"] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    print(f"15a: host time of one call: _C_ops.add "
          f"{out['c_ops_call_host_us']:.2f} us, paddle.add "
          f"{out['eager_call_host_us']:.2f} us", flush=True)
    return out


def drive_capi_gpt(run, paddle, TH, GPTConfig, mods, fa, torch,
                   eager=None, layer=None):
    """Phase 15b: GPT-1.3B's forward and backward written in paddle._C_ops
    (capi_gpt_loss), every count zeroed just before it and read just
    after; then 3 steps of ops.extra.adamw_ with f32 master weights."""
    from paddle_tpu_torch import _C_ops as C
    label, fields, batch, seq, tier, kernels, *_ = PATHS[0]
    cfg = GPTConfig(**fields)
    L = cfg.num_layers
    pcfg = TH.ParallelConfig(remat=False, fused_ce=False,
                             param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16)
    paddle.set_device("gpu:0")
    tparams = TH.init_params(cfg, pcfg,
                             torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    params = TH.eager_params_from_jax(tparams, device="cuda")
    del tparams
    every = [v for k, v in sorted(params.items()) if k != "blocks"] \
        + [v for _, v in sorted(params["blocks"].items())]
    ids_np = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              (batch, seq))
    ids = paddle.to_tensor(ids_np)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods:
        mod.reset_launch_counts()
    ticks0 = fa.dispatch_counts()
    loss = capi_gpt_loss(C, params, ids, cfg)
    loss.backward()
    torch.cuda.synchronize()
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    dispatch = fa.dispatch_counts(ticks0)
    capi_loss = float(loss)
    del loss
    with paddle.no_grad():
        eager_loss = float(eager_gpt_loss(paddle, params, ids, cfg))
    print(f"15b capi gpt ({label}, bf16, remat off, plain CE): step-0 loss "
          f"{capi_loss:.6f} through _C_ops, {eager_loss:.6f} eager (phase "
          f"7b's function); launches {launches}; dispatch {dispatch}",
          flush=True)
    run.check(10.0 <= capi_loss <= 11.5
              and abs(capi_loss - eager_loss) <= 1e-2,
              f"15b: step-0 loss {capi_loss:.6f} in [10, 11.5] and within "
              f"1e-2 of eager_gpt_loss's {eager_loss:.6f}")
    run.check(launches == {n: L if n in kernels else 0 for n in launches}
              and dispatch == {("attn.dispatch", tier): L},
              f"15b: one forward+backward launches each of {list(kernels)} "
              f"{L} times and no other attention kernel, {L} dispatches to "
              f"{tier}")

    # adamw_ with f32 master weights, in place
    state = []
    with paddle.no_grad():
        for p in every:
            state.append((paddle.zeros(p.shape, "float32"),
                          paddle.zeros(p.shape, "float32"),
                          paddle.to_tensor(np.float32(1.0)),
                          paddle.to_tensor(np.float32(1.0)),
                          p.astype("float32")))
    lr = paddle.to_tensor(np.float32(CAPI_LR))

    def fwd_bwd():
        for t in every:
            t.clear_grad()
        out = capi_gpt_loss(C, params, ids, cfg)
        out.backward()
        return out

    def opt_step():
        for p, (m1, m2, b1, b2, mw) in zip(every, state):
            paddle.ops.extra.adamw_(p, p.grad, lr, m1, m2, b1, b2,
                                    master_param=mw, coeff=0.01,
                                    multi_precision=True)

    losses, fb_ms, opt_ms = [], [], []
    for _ in range(CAPI_STEPS):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(3))
        e0.record()
        out = fwd_bwd()
        e1.record()
        opt_step()
        e2.record()
        torch.cuda.synchronize()
        losses.append(float(out))
        fb_ms.append(e0.elapsed_time(e1))
        opt_ms.append(e1.elapsed_time(e2))
        del out
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    master_ok = all(mw._data.dtype == torch.float32
                    and p._data.dtype == torch.bfloat16
                    and torch.equal(mw._data.to(torch.bfloat16), p._data)
                    for p, (*_, mw) in zip(every, state))
    run.check(all(math.isfinite(v) for v in losses)
              and losses[-1] < losses[0] and master_ok,
              f"15b: {CAPI_STEPS} adamw_ steps (multi_precision, f32 master "
              f"weights) on the same batch: losses {losses} fall; each bf16 "
              "parameter is its master weight rounded")
    fb = float(np.median(fb_ms[1:]))
    op = float(np.median(opt_ms[1:]))
    step_ms = fb + op
    tokens_s = batch * seq / (step_ms / 1e3)
    mfu = FLOP_PER_TOKEN_1P3B * tokens_s / PEAK_BF16_FLOPS
    wall_ms, rows = _profiled(torch, lambda: (fwd_bwd(), opt_step()))
    busy = sum(r[1] for r in rows)
    idle = max(0.0, 1 - busy / wall_ms)
    for key, ms, count in rows[:8]:
        print(f"  {ms:9.3f} ms {count:6d}x  {key[:100]}")
    beside = {
        "phase_7b_eager_fwd_bwd_ms": eager and eager.get("fwd_bwd_ms"),
        "phase_7b_gpt_hybrid_fwd_bwd_ms":
            eager and eager.get("gpt_hybrid_fwd_bwd_ms"),
        "phase_8b_layer_ms_per_step": layer and layer.get("ms_per_step"),
        "phase_8b_layer_tokens_per_s": layer and layer.get("tokens_per_s")}
    print(f"15b: forward+backward {fb:.2f} ms, adamw_ {op:.2f} ms, "
          f"{step_ms:.2f} ms/step, {tokens_s:.0f} tokens/s, MFU {mfu:.4f}, "
          f"peak memory {peak_gb:.2f} GB, profiled step {wall_ms:.2f} ms wall"
          f" {busy:.2f} ms kernel time, idle share {idle:.3f}; beside: "
          f"{beside}", flush=True)
    del params, every, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"step0_loss": capi_loss, "eager_step0_loss": eager_loss,
            "launches": launches, "losses": losses,
            "fwd_bwd_ms": fb, "fwd_bwd_ms_all": fb_ms, "opt_ms": op,
            "opt_ms_all": opt_ms, "ms_per_step": step_ms,
            "tokens_per_s": tokens_s, "mfu": mfu, "peak_memory_gb": peak_gb,
            "profiled_ms": wall_ms, "kernel_ms": busy, "idle_share": idle,
            **beside}


def ptb_language_model(paddle, cfg):
    """The PTB LSTM LM in the Layer API: Embedding, a multi-layer LSTM, a
    Linear head, dropout on the non-recurrent connections (Zaremba et al.
    2014), every parameter uniform in +-init."""
    nn = paddle.nn

    class PTBLanguageModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(cfg["vocab"], cfg["hidden"])
            self.lstm = nn.LSTM(cfg["hidden"], cfg["hidden"],
                                num_layers=cfg["layers"],
                                dropout=cfg["dropout"])
            self.head = nn.Linear(cfg["hidden"], cfg["vocab"])

        def forward(self, ids, labels):
            p = cfg["dropout"]
            x = nn.functional.dropout(self.embedding(ids), p,
                                      training=self.training)
            out, _ = self.lstm(x)
            out = nn.functional.dropout(out, p, training=self.training)
            logits = self.head(out)
            return nn.functional.cross_entropy(
                logits.reshape([-1, cfg["vocab"]]), labels.reshape([-1]))
    model = PTBLanguageModel()
    for prm in model.parameters():
        prm.set_value(paddle.uniform(prm.shape, min=-cfg["init"],
                                     max=cfg["init"]))
    return model


def _ptb_batch(cfg, seed):
    r = np.random.RandomState(seed)
    seq = r.randint(0, cfg["vocab"], (cfg["batch"], cfg["steps"] + 1))
    return seq[:, :-1], seq[:, 1:]


def check_small_lstm(run, paddle, torch):
    """Phase 15c, the small copy (vocab 50, hidden 32, dropout 0): on the
    card (cuDNN's LSTM) against the CPU from one state_dict: the loss and
    every gradient within 1e-5 of its scale."""
    from paddle_tpu_torch.nn.layer import rnn
    cfg = PTB_SMALL
    x, y = _ptb_batch(cfg, 0)
    got = {}
    state = None
    for dev in ("cpu", "gpu:0"):
        paddle.set_device(dev)
        paddle.seed(0)
        model = ptb_language_model(paddle, cfg)
        if state is None:
            state = {k: v.numpy() for k, v in model.state_dict().items()}
        else:
            model.set_state_dict(state)
        rnn.reset_routes()
        loss = model(paddle.to_tensor(x), paddle.to_tensor(y))
        loss.backward()
        got[dev] = (float(loss), {k: p.grad.numpy()
                                  for k, p in model.named_parameters()},
                    dict(rnn.ROUTES))
    (lc, gc_, rc), (lg, gg, rg) = got["cpu"], got["gpu:0"]
    worst = max(float(np.max(np.abs(gg[k] - gc_[k])))
                / max(float(np.max(np.abs(gc_[k]))), 1e-30) for k in gc_)
    run.check(abs(lg - lc) <= 1e-5 * abs(lc) and worst <= 1e-5
              and rg["cudnn"] == cfg["layers"] and rc["aten"] == cfg["layers"],
              f"15c small LSTM LM (vocab 50, hidden 32): loss {lg:.7f} card, "
              f"{lc:.7f} CPU; worst gradient {worst:.3e} of its scale "
              f"(tolerance 1e-5); routes card {rg}, CPU {rc}")
    return {"loss_card": lg, "loss_cpu": lc, "worst_grad_rel": worst}


def drive_ptb_lstm(run, paddle, torch):
    """Phase 15c: the PTB large LSTM LM, trained with SGD(1.0) and global
    norm clipping at 10 on one repeated batch."""
    from paddle_tpu_torch.nn.layer import rnn
    cfg = PTB_LARGE
    paddle.set_device("gpu:0")
    paddle.seed(0)
    model = ptb_language_model(paddle, cfg)
    opt = paddle.optimizer.SGD(
        learning_rate=cfg["lr"], parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(cfg["clip"]))
    x_np, y_np = _ptb_batch(cfg, 1)
    x, y = paddle.to_tensor(x_np), paddle.to_tensor(y_np)

    def step():
        loss = model(x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    rnn.reset_routes()
    losses, ms = [], []
    for _ in range(PTB_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    routes = dict(rnn.ROUTES)
    ln_v = math.log(cfg["vocab"])
    run.check(abs(losses[0] - ln_v) <= 0.1 and losses[-1] < losses[0]
              and all(math.isfinite(v) for v in losses)
              and routes == {"cudnn": cfg["layers"] * PTB_TRAIN_STEPS,
                             "aten": 0},
              f"15c PTB large LSTM LM: step-0 loss {losses[0]:.4f} within 0.1 "
              f"of ln(10000) = {ln_v:.4f}; losses {[round(v, 4) for v in losses]}"
              f" fall over {PTB_TRAIN_STEPS} steps on one batch; routes "
              f"{routes}")
    timed = ms[1:]
    med = float(np.median(timed))
    tokens = cfg["batch"] * cfg["steps"]
    wall_ms, rows = _profiled(torch, step)
    busy = sum(r[1] for r in rows)
    idle = max(0.0, 1 - busy / wall_ms)
    for key, kms, count in rows[:6]:
        print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
    print(f"15c: {med:.2f} ms/step (median of steps 2-{PTB_TRAIN_STEPS}, "
          f"spread {max(timed) - min(timed):.2f}), {tokens / med * 1e3:.0f} "
          f"tokens/s, profiled step {wall_ms:.2f} ms wall {busy:.2f} ms "
          f"kernel time, idle share {idle:.3f}, recurrence route "
          f"{'cudnn' if routes['cudnn'] else 'aten'}", flush=True)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "ms_per_step": med,
            "ms_per_step_spread": max(timed) - min(timed),
            "ms_all": ms, "tokens_per_s": tokens / med * 1e3,
            "profiled_ms": wall_ms, "kernel_ms": busy, "idle_share": idle,
            "route": "cudnn" if routes["cudnn"] else "aten",
            "routes": routes}


def drive_eager_api(run, paddle, TH, GPTConfig, mods, fa, torch, eager=None,
                    layer=None):
    """Phase 15: 15a the _C_ops surface, 15b GPT-1.3B through _C_ops, 15c
    the PTB large LSTM LM."""
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    out["c_ops"] = check_c_ops_surface(run, paddle, torch)
    out["c_ops"]["phase_s"] = time.perf_counter() - t0
    print(f"15a: {out['c_ops']['phase_s']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["gpt_capi"] = drive_capi_gpt(run, paddle, TH, GPTConfig, mods, fa,
                                     torch, eager, layer)
    out["gpt_capi"]["phase_s"] = time.perf_counter() - t0
    print(f"15b: {out['gpt_capi']['phase_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    out["ptb_lstm"] = {"small": check_small_lstm(run, paddle, torch)}
    out["ptb_lstm"].update(drive_ptb_lstm(run, paddle, torch))
    out["ptb_lstm"]["phase_s"] = time.perf_counter() - t0
    print(f"15c: {out['ptb_lstm']['phase_s']:.1f} s", flush=True)
    paddle.set_device("gpu:0")
    out["phase_15_s"] = time.perf_counter() - t_phase
    print(f"eager API phase: {out['phase_15_s']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------- phase 16
# Collective parallelism over torch.distributed on the card, at world 1 over
# NCCL (one card: its kernels and the code that N ranks run), and two ranks
# on the one card. NCCL refuses two ranks on one device (NCCL 2.28.9 on an
# NVIDIA H100 80GB HBM3: "Duplicate GPU detected : rank 0 and rank 1 both on
# CUDA device"), so 16d runs DataParallel over gloo with the card's tensors.
DP2_BACKEND = "gloo"
# 16b: benchmarks/workloads/gpt_dp_sharding1.py's full configuration at one
# rank (GPT-1.3B: h2048, 24 layers, 16 heads of 128, vocab 50304; B4 S1024;
# bf16, remat "names", fused CE, ParallelConfig(dp=1, zero1=True)).
DP_FLAGSHIP = PATHS[0]
DP_COMPARED, DP_TIMED = 3, 5
# 16d: GPT-3 Medium's widths (Brown et al. 2020, Table 2.1: d_model 1024,
# 24 layers, 16 heads of 64) at B4 S1024, two ranks of B2 each.
DP_MEDIUM = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                 num_heads=16, max_seq_len=1024)
DP_MEDIUM_BATCH, DP_MEDIUM_SEQ = 4, 1024
# all-reduce sizes of 16a, bytes
ALL_REDUCE_BYTES = (1 << 20, 256 << 20)


def _nccl_rows(rows):
    return [r for r in rows if "nccl" in r[0].lower()]


def _op_and_device_rows(torch, fn):
    """(the NCCL op records, the device rows with time) of one profiled
    call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return (sorted({e.key for e in events if e.key.startswith("nccl:")}),
            sorted({e.key for e in events
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0}))


def check_collectives(run, paddle, dist, torch):
    """16a: every eager collective on CUDA tensors at world 1 over NCCL
    (f32 and bf16) against its world-1 value; sync_op=False handles; what
    one profiled all-reduce and reduce-scatter run on the card; the
    all-reduce's time at 1 MB and 256 MB, the reduce-scatter's and
    all-gather's at 256 MB."""
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.distributed import collective as C
    group = dist.init_parallel_env()
    run.check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
              and group.rank == 0,
              f"16a: init_parallel_env over {dist.get_backend()}, world "
              f"{dist.get_world_size()}, cuda:{torch.cuda.current_device()}")
    bad = []
    for dt in (torch.float32, torch.bfloat16):
        x = torch.arange(1, 9, device="cuda", dtype=torch.float32).to(dt)

        def t():
            return Tensor._wrap(x.clone())

        def same(got, what):
            a = got._data if isinstance(got, Tensor) else got
            if not (a.is_cuda and a.dtype == dt and torch.equal(a, x)):
                bad.append(f"{what} {dt}")
        for op in ("SUM", "AVG", "MAX", "MIN", "PROD"):
            y = t()
            dist.all_reduce(y, getattr(dist.ReduceOp, op))
            same(y, f"all_reduce {op}")
        y = t()
        task = dist.all_reduce(y, sync_op=False)
        task.wait()
        same(y, "all_reduce sync_op=False")
        outs = []
        dist.all_gather(outs, t(), sync_op=False).wait()
        same(outs[0], "all_gather")
        y = t()
        dist.broadcast(y, src=0)
        same(y, "broadcast")
        y = t()
        dist.reduce(y, dst=0)
        same(y, "reduce")
        y = Tensor._wrap(torch.zeros_like(x))
        dist.scatter(y, [t()], src=0)
        same(y, "scatter")
        y = Tensor._wrap(torch.zeros_like(x))
        dist.reduce_scatter(y, [t()])
        same(y, "reduce_scatter")
        outs = []
        dist.alltoall([t()], outs)
        same(outs[0], "alltoall")
        y = Tensor._wrap(torch.zeros_like(x))
        dist.alltoall_single(t(), y)
        same(y, "alltoall_single")
        outs = []
        dist.gather(t(), outs, dst=0)
        same(outs[0], "gather")
        y = Tensor._wrap(torch.zeros_like(x))
        for task in dist.batch_isend_irecv([dist.P2POp(dist.isend, t(), 0),
                                            dist.P2POp(dist.irecv, y, 0)]):
            task.wait()
        same(y, "batch_isend_irecv to itself")
        flat = torch.zeros_like(x)
        C.reduce_scatter_flat(flat, x.clone())
        same(flat, "reduce_scatter_flat")
        full = x.clone()
        C.all_gather_flat(full, full)
        same(full, "all_gather_flat in place")
    objs = []
    dist.all_gather_object(objs, {"rank": 0})
    got = [None]
    dist.broadcast_object_list(got, src=0)
    out = []
    dist.scatter_object_list(out, [{"x": 1}], src=0)
    dist.barrier()
    torch.cuda.synchronize()
    run.check(not bad and objs == [{"rank": 0}] and out == [{"x": 1}],
              f"16a: 17 tensor collectives a dtype (f32, bf16) and three "
              f"object collectives give their world-1 values on the card"
              f"{'; wrong: ' + ', '.join(bad) if bad else ''}")
    timings = {}
    for nbytes in ALL_REDUCE_BYTES:
        buf = torch.ones(nbytes // 4, device="cuda")
        timings[f"all_reduce_{nbytes >> 20}MB"] = windows_ms(
            lambda: C.all_reduce_flat(buf, C.ReduceOp.SUM), reps=20)
    big = torch.ones(ALL_REDUCE_BYTES[-1] // 4, device="cuda")
    other = torch.empty_like(big)
    timings[f"reduce_scatter_{ALL_REDUCE_BYTES[-1] >> 20}MB"] = windows_ms(
        lambda: C.reduce_scatter_flat(other, big, C.ReduceOp.SUM), reps=20)
    timings[f"all_gather_{ALL_REDUCE_BYTES[-1] >> 20}MB"] = windows_ms(
        lambda: C.all_gather_flat(other, big), reps=20)
    # at world 1 ProcessGroupNCCL launches no NCCL kernel: its in-place
    # all-reduce moves nothing, and its out-of-place reduce-scatter and
    # all-gather are one device-to-device copy each ("Memcpy DtoD") under
    # the op's "nccl:*" record (torch 2.11, NCCL 2.28.9, NVIDIA H100 80GB
    # HBM3). The profiler's device rows of so short a window can come back
    # empty late in this script, so the copy is shown by its time: at least
    # its bytes (read and written) over the HBM rate
    seen = {}
    for name, fn in (("all_reduce", lambda: C.all_reduce_flat(
            big, C.ReduceOp.SUM)), ("reduce_scatter", lambda: C.
            reduce_scatter_flat(other, big, C.ReduceOp.SUM))):
        seen[name] = _op_and_device_rows(torch, fn)
    ops, rows = seen["reduce_scatter"]
    rs_ms = timings[f"reduce_scatter_{ALL_REDUCE_BYTES[-1] >> 20}MB"][0]
    copy_ms = 2 * ALL_REDUCE_BYTES[-1] / PEAK_HBM_BYTES * 1e3
    run.check(any(k.startswith("nccl:") for k in ops) and rs_ms >= copy_ms,
              f"16a: a profiled reduce-scatter runs through NCCL ({ops}) "
              f"and its copy takes {rs_ms * 1e3:.1f} us, at least its bytes "
              f"over HBM ({copy_ms * 1e3:.1f} us); device rows {rows}")
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "reduce_scatter_ops": ops, "reduce_scatter_device_rows": rows,
           "all_reduce_ops": seen["all_reduce"][0],
           "all_reduce_device_rows": seen["all_reduce"][1],
           "copy_bound_us": copy_ms * 1e3}
    for name, (ms, spread) in timings.items():
        nbytes = int(name.rsplit("_", 1)[1][:-2]) << 20
        gbs = nbytes / (ms / 1e3) / 1e9
        out[f"{name}_us"] = ms * 1e3
        out[f"{name}_us_spread"] = spread * 1e3
        out[f"{name}_GBps"] = gbs
        print(f"16a: {name} f32 at world 1: {ms * 1e3:.1f} us (spread "
              f"{spread * 1e3:.1f}), {gbs:.1f} GB/s (bytes / time)",
              flush=True)
    print(f"16a: a profiled all-reduce: ops {out['all_reduce_ops']}, device "
          f"rows {out['all_reduce_device_rows']}; a reduce-scatter: ops "
          f"{ops}, device rows {rows}", flush=True)
    del big, other
    return out


def _flagship_single(TH, GPTConfig, torch, steps):
    """The flagship's single-device losses and ms/step (phase 4's step,
    before any process group exists, each step timed by CUDA events): the
    same-time baseline of 16b, and its reference when phase 4 did not
    run."""
    label, fields, batch, seq, *_ = DP_FLAGSHIP
    cfg = GPTConfig(**fields)
    pcfg = TH.ParallelConfig(remat=True, remat_policy="names", fused_ce=True,
                             param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16, zero1=True)
    params, opt_state, step = TH.setup(cfg, pcfg, seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    losses, times = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(params, opt_state, (ids, ids))[2]
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return losses, float(np.median(times[1:]))


def drive_dp_gpt(run, TH, GPTConfig, mods, fa, cost_model, torch,
                 single_losses, single_ms, now_ms):
    """16b: the main path, gpt_dp_sharding1.py's full configuration through
    setup() and the data-parallel step at world 1 over NCCL."""
    label, fields, batch, seq, tier, kernels, *_ = DP_FLAGSHIP
    cfg = GPTConfig(**fields)
    L = cfg.num_layers
    pcfg = TH.ParallelConfig(dp=1, remat=True, remat_policy="names",
                             fused_ce=True, param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16, zero1=True)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, step = TH.setup(cfg, pcfg, seed=0)
    buckets = TH._bind_flat(params, 1)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    torch.cuda.synchronize()
    for mod in mods:
        mod.reset_launch_counts()
    losses = [float(step(params, opt_state, (ids, ids))[2])
              for _ in range(DP_COMPARED)]
    torch.cuda.synchronize()
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    times = []
    for _ in range(DP_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(params, opt_state, (ids, ids))[2]
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
    ms = float(np.median(times))
    tok_s = batch * seq / (ms / 1e3)
    fpt = cost_model.gpt_flops_per_token(cfg, seq)
    mfu = cost_model.mfu(tok_s, fpt, "H100")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, (ids, ids))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    nccl_ops = sorted({e.key for e in prof.key_averages()
                       if e.key.startswith("nccl:")})
    # the device time the profiler files under the NCCL records (at world 1
    # the copies that ProcessGroupNCCL issues); counted once in busy
    nccl_ms = sum(r[1] for r in _nccl_rows(rows))
    busy = sum(r[1] for r in rows) - nccl_ms
    idle = max(0.0, 1 - busy / wall_ms)
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(losses[:DP_COMPARED], single_losses[:DP_COMPARED]))
    print(f"16b {label} dp=1 zero1 over NCCL: losses "
          f"{[round(x, 4) for x in losses]}; single-device "
          f"{[round(x, 4) for x in single_losses[:DP_COMPARED]]}",
          flush=True)
    run.check(rel <= TOL["bfloat16"],
              f"16b: the distributed step's {DP_COMPARED} losses equal the "
              f"single-device step's (phase 4) within {TOL['bfloat16']} "
              f"relative (bf16): worst {rel:.3e}")
    run.check(launches == {n: L * DP_COMPARED if n in kernels else 0
                           for n in launches},
              f"16b: {L} launches a step of each of {list(kernels)} over "
              f"{DP_COMPARED} steps, no other attention kernel: {launches}")
    run.check(10.0 <= losses[0] <= 11.5 and losses[-1] < losses[0]
              and all(map(math.isfinite, losses)),
              f"16b: step-0 loss {losses[0]:.4f} in [10, 11.5] and the loss "
              f"falls to {losses[-1]:.4f}")
    want_ops = {"nccl:_reduce_scatter_base", "nccl:_all_gather_base"}
    run.check(len(buckets) == 1 and want_ops <= set(nccl_ops),
              f"16b: one gradient bucket (bf16), reduce-scattered and "
              f"all-gathered through NCCL in the profiled step: {nccl_ops}, "
              f"{nccl_ms:.3f} ms of device time under them")
    print(f"16b: {ms:.2f} ms/step (device events, median of {DP_TIMED}, "
          f"spread {max(times) - min(times):.2f}) beside phase 4's "
          f"{single_ms if single_ms is None else round(single_ms, 2)} and "
          f"the single-device step's {now_ms:.2f} just before this phase; "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} at {fpt:.4e} FLOP/token, "
          f"peak memory {peak_gb:.2f} GB; profiled step {wall_ms:.2f} ms wall, "
          f"{busy:.2f} ms kernel time, NCCL {nccl_ms:.3f} ms, idle share "
          f"{idle:.3f}", flush=True)
    for key, kms, count in rows[:10]:
        print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "single_device_losses":
            single_losses[:DP_COMPARED], "loss_rel_err": rel,
            "ms_per_step": ms, "ms_per_step_spread": max(times) - min(times),
            "single_device_ms_per_step": single_ms,
            "single_device_ms_now": now_ms, "tokens_per_s": tok_s,
            "mfu": mfu, "flops_per_token": fpt, "peak_memory_gb": peak_gb,
            "profiled_ms": wall_ms, "kernel_ms": busy, "nccl_ms": nccl_ms,
            "nccl_ops": nccl_ops, "idle_share": idle, "buckets": len(buckets),
            "launches": launches}


def _layer_gpt_steps(paddle, dist, GPTConfig, GPTForCausalLM, fa, torch,
                     wrap, steps):
    """(losses, ms per step, launches per step) of the Layer GPT-1.3B
    (phase 8b's model, seed, batch and optimizer) wrapped by ``wrap``."""
    cfg = GPTConfig.gpt3_1p3b()
    paddle.seed(0)
    model = GPTForCausalLM(cfg)
    model.bfloat16()
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    model, opt = wrap(model, opt)
    ids = paddle.to_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LAYER_GPT_BATCH, LAYER_GPT_SEQ)))
    losses, times, launches = [], [], []
    for _ in range(steps):
        fa.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = model(ids, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
        launches.append(dict(fa.LAUNCHES))
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses, times, launches


def drive_layer_dp(run, paddle, dist, GPTConfig, GPTForCausalLM, fa, torch,
                   layer=None):
    """16c: the Layer GPT-1.3B through DataParallel, then through
    group_sharded_parallel(level="os_g"), 3 steps of AdamW each, against
    phase 8b's plain run (and a plain run just before, for the time)."""
    L = GPTConfig.gpt3_1p3b().num_layers
    now, ptimes, _ = _layer_gpt_steps(
        paddle, dist, GPTConfig, GPTForCausalLM, fa, torch,
        lambda m, o: (m, o), DP_COMPARED)
    now_ms = float(np.median(ptimes[1:]))
    if layer is None:
        plain, plain_ms = now, now_ms
    else:
        plain, plain_ms = layer["losses"], layer["ms_per_step"]
    out = {"plain_losses": plain[:DP_COMPARED], "plain_ms_per_step": plain_ms,
           "plain_ms_now": now_ms}
    wraps = {
        "data_parallel": lambda m, o: (dist.DataParallel(m), o),
        "group_sharded_os_g": lambda m, o: dist.group_sharded_parallel(
            m, o, level="os_g")[:2],
    }
    for name, wrap in wraps.items():
        losses, times, launches = _layer_gpt_steps(
            paddle, dist, GPTConfig, GPTForCausalLM, fa, torch, wrap,
            DP_COMPARED)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
        want = {n: L if n in fa.LAUNCHES else 0 for n in launches[0]}
        ms = float(np.median(times[1:]))
        run.check(rel <= TOL["bfloat16"] and all(x == want for x in launches)
                  and losses[-1] < losses[0],
                  f"16c {name}: losses {[round(x, 4) for x in losses]} equal "
                  f"phase 8b's {[round(x, 4) for x in plain[:DP_COMPARED]]} "
                  f"within {TOL['bfloat16']} relative (worst {rel:.3e}), "
                  f"{L} launches a step of each library kernel, and fall")
        print(f"16c {name}: {ms:.2f} ms/step (device events, median of steps "
              f"2-{DP_COMPARED}) beside phase 8b's {plain_ms:.2f} and the "
              f"plain Layer GPT's {now_ms:.2f} just before", flush=True)
        out[name] = {"losses": losses, "loss_rel_err": rel,
                     "ms_per_step": ms, "step_ms": times}
    return out


def phase16d_worker(out_dir):
    """One rank of 16d, started by the port's launcher: DataParallel over
    DP2_BACKEND with the card's tensors, this rank's rows of the global
    batch; rank 0 writes the global losses and times."""
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    paddle.set_device("gpu:0")
    dist.init_parallel_env(backend=DP2_BACKEND)
    rank, world = dist.get_rank(), dist.get_world_size()
    paddle.seed(0)
    model = GPTForCausalLM(GPTConfig(**DP_MEDIUM))
    model.bfloat16()
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    dp = dist.DataParallel(model)
    reducer = dp._reducer
    reduce_ms = []
    bucket = reducer.reduce_bucket

    def timed_bucket(b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bucket(b)
        torch.cuda.synchronize()
        reduce_ms[-1] += (time.perf_counter() - t0) * 1e3
    reducer.reduce_bucket = timed_bucket
    ids = np.random.RandomState(0).randint(
        0, DP_MEDIUM["vocab_size"], (DP_MEDIUM_BATCH, DP_MEDIUM_SEQ))
    n = DP_MEDIUM_BATCH // world
    local = paddle.to_tensor(ids[rank * n:(rank + 1) * n])
    losses, step_ms = [], []
    for _ in range(DP_COMPARED):
        reduce_ms.append(0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = dp(local, local)
        loss.backward()
        opt.step()
        opt.clear_grad()
        g = loss._data.detach().float().reshape(1).clone()
        dist.all_reduce(g, dist.ReduceOp.AVG)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(g[0]))
    if rank == 0:
        with open(os.path.join(out_dir, "dp2.json"), "w") as f:
            json.dump({"losses": losses, "step_ms": step_ms,
                       "reduce_ms": reduce_ms, "world": world,
                       "backend": dist.get_backend(),
                       "buckets": len(reducer.buckets)}, f)
    dist.destroy_process_group()


def drive_two_ranks(run, paddle, GPTConfig, GPTForCausalLM, torch):
    """16d: two ranks on the one card, started by the port's launcher,
    against a world-1 run of the same global batch in this process."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=os.path.join(root, ".cache")) as d:
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "2", os.path.abspath(__file__),
             "--phase16d-worker", d],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            _, err = proc.communicate()
        wall = time.perf_counter() - t0
        ok = proc.returncode == 0 and os.path.exists(os.path.join(d,
                                                                  "dp2.json"))
        run.check(ok, f"16d: two ranks over {DP2_BACKEND} on the one card "
                  f"ran (rc {proc.returncode}, {wall:.1f} s){'' if ok else ': ' + err[-1500:]}")
        if not ok:
            return {"backend": DP2_BACKEND, "rc": proc.returncode}
        with open(os.path.join(d, "dp2.json")) as f:
            two = json.load(f)
    paddle.set_device("gpu:0")
    paddle.seed(0)
    model = GPTForCausalLM(GPTConfig(**DP_MEDIUM))
    model.bfloat16()
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    ids = paddle.to_tensor(np.random.RandomState(0).randint(
        0, DP_MEDIUM["vocab_size"], (DP_MEDIUM_BATCH, DP_MEDIUM_SEQ)))
    one, one_ms = [], []
    for _ in range(DP_COMPARED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model(ids, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
        one.append(float(loss))
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(two["losses"], one))
    run.check(rel <= TOL["bfloat16"] and two["world"] == 2
              and two["backend"] == DP2_BACKEND,
              f"16d: rank 0's global losses {[round(x, 4) for x in two['losses']]}"
              f" over 2 ranks ({two['backend']}) equal the world-1 run's "
              f"{[round(x, 4) for x in one]} within {TOL['bfloat16']} "
              f"relative (worst {rel:.3e})")
    ms2 = float(np.median(two["step_ms"][1:]))
    red = float(np.median(two["reduce_ms"][1:]))
    print(f"16d: GPT-3 Medium widths, B{DP_MEDIUM_BATCH} S{DP_MEDIUM_SEQ}: "
          f"two ranks over {DP2_BACKEND} {ms2:.1f} ms/step (host clock, "
          f"median of steps 2-{DP_COMPARED}; the reduction {red:.1f} ms of "
          f"it, {two['buckets']} buckets); world 1 "
          f"{float(np.median(one_ms[1:])):.1f} ms/step", flush=True)
    return {"backend": DP2_BACKEND, "two_rank_losses": two["losses"],
            "world1_losses": one, "loss_rel_err": rel,
            "ms_per_step": ms2, "step_ms": two["step_ms"],
            "reduce_ms": red, "reduce_ms_all": two["reduce_ms"],
            "buckets": two["buckets"],
            "world1_ms_per_step": float(np.median(one_ms[1:])),
            "launcher_s": wall}


def drive_distributed(run, paddle, TH, GPTConfig, GPTForCausalLM, mods, fa,
                      cost_model, torch, flagship=None, layer=None):
    """Phase 16: 16a collectives, 16b the dp + ZeRO-1 GPT-1.3B step,
    16c the Layer GPT-1.3B through DataParallel and ZeRO stage 2, 16d two
    ranks on the one card."""
    import paddle_tpu_torch.distributed as dist
    t_phase = time.perf_counter()
    import threading
    paddle.set_device("gpu:0")
    print(f"16: {len(gc.get_objects())} objects tracked by gc, "
          f"{threading.active_count()} threads in this process", flush=True)
    now, now_ms = _flagship_single(TH, GPTConfig, torch, DP_COMPARED)
    if flagship is None:
        single, single_ms = now, None
    else:
        single, single_ms = flagship["losses"], flagship["ms_per_step"]
    out = {}
    t0 = time.perf_counter()
    out["collectives"] = check_collectives(run, paddle, dist, torch)
    print(f"16a: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out["dp_zero1_gpt"] = drive_dp_gpt(run, TH, GPTConfig, mods, fa,
                                       cost_model, torch, single, single_ms,
                                       now_ms)
    print(f"16b: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out["layer_gpt"] = drive_layer_dp(run, paddle, dist, GPTConfig,
                                      GPTForCausalLM, fa, torch, layer)
    print(f"16c: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out["two_ranks"] = drive_two_ranks(run, paddle, GPTConfig,
                                       GPTForCausalLM, torch)
    print(f"16d: {time.perf_counter() - t0:.1f} s", flush=True)
    dist.destroy_process_group()
    out["phase_16_s"] = time.perf_counter() - t_phase
    print(f"distributed phase: {out['phase_16_s']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------- phase 17
# Tensor and sequence parallelism over torch.distributed (the manual-tp
# block over the tp group, the sp linears, the ring collective matmuls,
# ring and Ulysses attention). The card holds one rank of NCCL (17a, 17b:
# the code that N ranks run, at world 1) and two ranks of gloo (17c: NCCL
# refuses two ranks on one device, phase 16d).
# 17b: benchmarks/workloads/llama_tp_pp_sharding3.py's full configuration
# (Llama-7B dims: vocab 32000, h4096, 32 heads of 128, S2048; B2; bf16;
# remat "names", fused CE, zero1, sp) without pp, at dp = tp = 1. Depth is
# the only cut, 16 of its 32 layers: ~1.6 GB a layer of bf16 parameters,
# gradients and moments, and the single-device step's whole-leaf f32 update
# beside it, leave 32 layers no room on 80 GB.
TP_LLAMA = dict(vocab_size=32000, hidden_size=4096, num_layers=16,
                num_heads=32, max_seq_len=2048)
TP_BATCH, TP_SEQ = 2, 2048
TP_COMPARED, TP_TIMED = 3, 5
TP_KERNELS = ("causal_attention_fwd", "causal_attention_bwd")
# 17c: the same widths at 2 layers, tp = 2 over gloo with the card's tensors
TP2_LAYERS, TP2_BACKEND = 2, "gloo"


def _tp_pcfg(TH, torch, **fields):
    return TH.ParallelConfig(**{
        "remat": True, "remat_policy": "names", "fused_ce": True,
        "zero1": True, "param_dtype": torch.bfloat16,
        "compute_dtype": torch.bfloat16, **fields})


def _tp_ids(torch, cfg):
    """The workload's batch: RandomState(0), the same ids every step."""
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TP_BATCH, TP_SEQ))).cuda()


def _timed_steps(torch, step, params, opt_state, batch, n):
    losses, times = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(params, opt_state, batch)[2]
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
    return losses, times


def check_tp_primitives(run, paddle, dist, torch):
    """17a: each tensor- and sequence-parallel primitive on the card at
    world 1 over NCCL against its plain single-device computation, f32 and
    bf16, the output and every input's gradient of sum(out * c):
    ColumnParallelLinear -> RowParallelLinear, VocabParallelEmbedding,
    ParallelCrossEntropy, the two sequence-parallel linears,
    all_gather_matmul and matmul_reduce_scatter, ring and Ulysses
    attention, causal and not."""
    import torch.nn.functional as tF
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.parallel.collective_matmul import (
        all_gather_matmul, matmul_reduce_scatter)
    from paddle_tpu_torch.parallel.ring_attention import ring_attention
    from paddle_tpu_torch.parallel.ulysses import ulysses_attention
    g = dist.init_parallel_env()
    run.check(dist.get_backend() == "nccl" and g.nranks == 1,
              f"17a: init_parallel_env over {dist.get_backend()}, world "
              f"{g.nranks}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}

    def randn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    def rel(a, b):
        a, b = a.detach().float(), b.detach().float()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def compare(name, dt, fn, plain, inputs):
        """fn and plain on leaf copies of inputs: the largest relative error
        of the output and of each input's gradient."""
        a = [x.clone().requires_grad_(x.is_floating_point()) for x in inputs]
        b = [x.clone().requires_grad_(x.is_floating_point()) for x in inputs]
        ya, yb = fn(*a), plain(*b)
        c = randn(yb.shape, torch.float32)
        (ya.float() * c).sum().backward()
        (yb.float() * c).sum().backward()
        errs[f"{name} {str(dt)[6:]}"] = max(
            [rel(ya, yb)] + [rel(x.grad, y.grad) for x, y in zip(a, b)
                             if x.grad is not None])

    def layer_fn(*layers):
        """f(x, *params): the layers chained, their params bound to the
        leaves given (so the gradients land on them)."""
        ps = [p for layer in layers for _, p in
              sorted(layer.named_parameters())]

        def f(x, *leaves):
            for p, w in zip(ps, leaves):
                p._data = w
            y = Tensor._wrap(x, not x.requires_grad)
            for layer in layers:
                y = layer(y)
            return y._data
        return f, [p._data.detach() for p in ps]

    h, ffn, vocab = 1024, 4096, 32000
    for dt in (torch.float32, torch.bfloat16):
        paddle.seed(0)
        col = fleet.ColumnParallelLinear(h, ffn, gather_output=False,
                                         mp_group=g)
        row = fleet.RowParallelLinear(ffn, h, input_is_parallel=True,
                                      mp_group=g)
        if dt == torch.bfloat16:
            col.bfloat16()
            row.bfloat16()
        f, ws = layer_fn(col, row)
        x = randn((2, 512, h), dt)
        compare("column->row linear", dt, f, lambda x, b1, w1, b2, w2:
                (x @ w1 + b1) @ w2 + b2, [x] + ws)
        scol = fleet.ColumnSequenceParallelLinear(h, ffn, mp_group=g)
        srow = fleet.RowSequenceParallelLinear(ffn, h, mp_group=g)
        if dt == torch.bfloat16:
            scol.bfloat16()
            srow.bfloat16()
        f, ws = layer_fn(scol, srow)
        compare("sequence-parallel linears", dt, f,
                lambda x, b1, w1, b2, w2: (x @ w1 + b1) @ w2 + b2, [x] + ws)
        emb = fleet.VocabParallelEmbedding(vocab, h, mp_group=g)
        if dt == torch.bfloat16:
            emb.bfloat16()
        f, ws = layer_fn(emb)
        ids = torch.randint(0, vocab, (2, 512), generator=gen,
                            device="cuda")
        compare("vocab-parallel embedding", dt, f,
                lambda i, w: tF.embedding(i, w), [ids] + ws)
        ce = fleet.ParallelCrossEntropy(mp_group=g)
        labels = torch.randint(0, vocab, (1024,), generator=gen,
                               device="cuda")
        labels[::7] = -100
        compare("parallel cross entropy", dt,
                lambda z: ce(Tensor._wrap(z, False),
                             Tensor._wrap(labels))._data,
                lambda z: tF.cross_entropy(z.float(), labels,
                                           reduction="none"),
                [randn((1024, vocab), dt, 4.0)])
        xs = randn((2048, 2, h), dt)
        compare("all_gather_matmul", dt,
                lambda x, w: all_gather_matmul(x, w, g),
                lambda x, w: x @ w, [xs, randn((h, ffn), dt, 0.03)])
        compare("matmul_reduce_scatter", dt,
                lambda x, w: matmul_reduce_scatter(x, w, g),
                lambda x, w: x @ w, [xs, randn((h, ffn), dt, 0.03)])
        qkv = [randn((1, 2048, 8, 128), dt) for _ in range(3)]
        for causal in (False, True):
            def plain(q, k, v, causal=causal):
                lg = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k.float()) / math.sqrt(q.shape[-1])
                if causal:
                    keep = torch.ones(lg.shape[-2:], dtype=torch.bool,
                                      device="cuda").tril()
                    lg = lg.masked_fill(~keep, -1e30)
                return torch.einsum("bhqk,bkhd->bqhd", lg.softmax(-1),
                                    v.float()).to(q.dtype)
            for name, fn in (("ring", ring_attention),
                             ("ulysses", ulysses_attention)):
                compare(f"{name} attention causal={causal}", dt,
                        lambda q, k, v, fn=fn, causal=causal:
                        fn(q, k, v, g, causal=causal), plain, qkv)
    worst = {}
    for name, err in errs.items():
        tol = 1e-5 if name.endswith("float32") else TOL["bfloat16"]
        worst[name] = err
        run.check(err <= tol, f"17a: {name} on the card over NCCL at world "
                  f"1 equals its plain form: {err:.3e} <= {tol}")
    return worst


def _tp_single(TH, GPTConfig, torch, cfg_fields, steps):
    """The losses and ms/step of the single-device step (no process group)
    of the same configuration, the baseline of 17b and 17c."""
    cfg = GPTConfig(**cfg_fields)
    params, opt_state, step = TH.setup(cfg, _tp_pcfg(TH, torch), seed=0)
    losses, times = _timed_steps(torch, step, params, opt_state,
                                 (_tp_ids(torch, cfg),) * 2, steps)
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return losses, float(np.median(times[1:]))


def drive_tp_gpt(run, paddle, dist, TH, GPTConfig, mods, cost_model, torch,
                 single, single_ms):
    """17b: the main path, llama_tp_pp_sharding3.py's configuration (16
    layers) through setup() and the tp + sp step at world 1 over NCCL, then
    with collective_matmul."""
    from paddle_tpu_torch.distributed import collective as C
    cfg = GPTConfig(**TP_LLAMA)
    L = cfg.num_layers
    dist.init_parallel_env()
    out = {}
    for cm in (False, True):
        pcfg = _tp_pcfg(TH, torch, dp=1, tp=1, sp=True,
                        collective_matmul=cm)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, opt_state, step = TH.setup(cfg, pcfg, seed=0)
        batch = (_tp_ids(torch, cfg),) * 2
        torch.cuda.synchronize()
        for mod in mods:
            mod.reset_launch_counts()
        staged0 = dict(C.HOST_STAGED)
        losses = [float(step(params, opt_state, batch)[2])
                  for _ in range(TP_COMPARED)]
        torch.cuda.synchronize()
        launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
        timed, times = _timed_steps(torch, step, params, opt_state, batch,
                                    TP_TIMED)
        losses += timed
        ms = float(np.median(times))
        tok_s = TP_BATCH * TP_SEQ / (ms / 1e3)
        fpt = cost_model.gpt_flops_per_token(cfg, TP_SEQ)
        mfu = cost_model.mfu(tok_s, fpt, "H100")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        label = "17b" + (" collective_matmul" if cm else "")
        if not cm:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(params, opt_state, batch)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rows = _device_rows(prof)
            nccl_ops = sorted({e.key for e in prof.key_averages()
                               if e.key.startswith("nccl:")})
            nccl_ms = sum(r[1] for r in _nccl_rows(rows))
            busy = sum(r[1] for r in rows) - nccl_ms
            idle = max(0.0, 1 - busy / wall_ms)
            ref = single
        else:
            ref = out["tp_sp"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(losses[:TP_COMPARED], ref[:TP_COMPARED]))
        staged = {k: v - staged0.get(k, 0) for k, v in C.HOST_STAGED.items()
                  if v != staged0.get(k, 0)}
        print(f"{label} Llama-7B widths, {L} layers, B{TP_BATCH} "
              f"S{TP_SEQ}, tp + sp at world 1 over NCCL: losses "
              f"{[round(x, 4) for x in losses]}; against "
              f"{[round(x, 4) for x in ref[:TP_COMPARED]]}", flush=True)
        what = "the single-device step's" if not cm else \
            "the step without collective_matmul's"
        run.check(rel <= TOL["bfloat16"],
                  f"{label}: the {TP_COMPARED} losses equal {what} within "
                  f"{TOL['bfloat16']} relative (bf16): worst {rel:.3e}")
        run.check(launches == {n: L * TP_COMPARED if n in TP_KERNELS else 0
                               for n in launches},
                  f"{label}: {L} launches a step of each of "
                  f"{list(TP_KERNELS)} over {TP_COMPARED} steps, no other "
                  f"attention kernel: {launches}")
        run.check(all(map(math.isfinite, losses))
                  and 10.0 <= losses[0] <= 11.5 and losses[-1] < losses[0],
                  f"{label}: step-0 loss {losses[0]:.4f} in [10, 11.5] "
                  f"(ln(32000) = 10.37) and the loss falls to "
                  f"{losses[-1]:.4f}")
        run.check(not staged, f"{label}: no collective took the host route "
                  f"(NCCL): {staged}")
        res = {"losses": losses, "loss_rel_err": rel, "ms_per_step": ms,
               "ms_per_step_spread": max(times) - min(times),
               "tokens_per_s": tok_s, "mfu": mfu, "flops_per_token": fpt,
               "peak_memory_gb": peak_gb, "launches": launches,
               "host_staged": staged}
        if not cm:
            res.update({"single_device_losses": single[:TP_COMPARED],
                        "single_device_ms_per_step": single_ms,
                        "profiled_ms": wall_ms, "kernel_ms": busy,
                        "nccl_ms": nccl_ms, "nccl_ops": nccl_ops,
                        "idle_share": idle})
            print(f"{label}: {ms:.2f} ms/step (device events, median of "
                  f"{TP_TIMED}, spread {max(times) - min(times):.2f}) beside "
                  f"the single-device step's {single_ms:.2f}; {tok_s:.1f} "
                  f"tokens/s, MFU {mfu:.4f} at {fpt:.4e} FLOP/token, peak "
                  f"memory {peak_gb:.2f} GB; profiled step {wall_ms:.2f} ms "
                  f"wall, {busy:.2f} ms kernel time, NCCL {nccl_ms:.3f} ms "
                  f"({nccl_ops}), idle share {idle:.3f}", flush=True)
            for key, kms, count in rows[:8]:
                print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
            out["tp_sp"] = res
        else:
            print(f"{label}: {ms:.2f} ms/step (spread "
                  f"{max(times) - min(times):.2f}) beside "
                  f"{out['tp_sp']['ms_per_step']:.2f} without it; peak "
                  f"{peak_gb:.2f} GB", flush=True)
            out["tp_sp_collective_matmul"] = res
        del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase17c_worker(out_dir):
    """One rank of 17c, started by the port's launcher: the tp = 2 + sp step
    over TP2_BACKEND with the card's tensors, each collective timed on the
    host clock; rank 0 writes the losses, times and counts."""
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.models import gpt_hybrid as TH
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops.hopper import causal_attention as ca
    paddle.set_device("gpu:0")
    dist.init_parallel_env(backend=TP2_BACKEND)
    rank, world = dist.get_rank(), dist.get_world_size()
    coll_ms = [0.0]

    def timed(fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                coll_ms[0] += (time.perf_counter() - t0) * 1e3
        return wrapper
    for name in ("_sum_over", "_gather_along", "_scatter_sum", "_exchange",
                 "_permute", "all_reduce_flat", "reduce_scatter_flat",
                 "all_gather_flat"):
        setattr(C, name, timed(getattr(C, name)))
    heads = set()
    attend = ca.attention_bhsd

    def counted(q, *a, **k):
        heads.add(int(q.shape[1]))
        return attend(q, *a, **k)
    ca.attention_bhsd = counted
    cfg = GPTConfig(**dict(TP_LLAMA, num_layers=TP2_LAYERS))
    pcfg = _tp_pcfg(TH, torch, tp=world, sp=True)
    params, opt_state, step = TH.setup(cfg, pcfg, seed=0)
    batch = (_tp_ids(torch, cfg),) * 2
    losses, step_ms, step_coll = [], [], []
    ca.reset_launch_counts()
    for _ in range(TP_COMPARED):
        coll_ms[0] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(params, opt_state, batch)[2]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_coll.append(coll_ms[0])
    if rank == 0:
        with open(os.path.join(out_dir, "tp2.json"), "w") as f:
            json.dump({"losses": losses, "step_ms": step_ms,
                       "collective_ms": step_coll, "world": world,
                       "backend": dist.get_backend(),
                       "launches": dict(ca.LAUNCHES),
                       "local_heads": sorted(heads),
                       "host_staged": dict(C.HOST_STAGED)}, f)
    dist.destroy_process_group()


def drive_tp_two_ranks(run, TH, GPTConfig, torch):
    """17c: two ranks at tp = 2 + sp on the one card over gloo, started by
    the port's launcher, against the single-device step of the same
    configuration from the same parameters in this process."""
    root = os.path.dirname(os.path.abspath(__file__))
    fields = dict(TP_LLAMA, num_layers=TP2_LAYERS)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, ".cache")) as d:
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "2", os.path.abspath(__file__),
             "--phase17c-worker", d],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            _, err = proc.communicate()
        wall = time.perf_counter() - t0
        ok = proc.returncode == 0 and os.path.exists(os.path.join(d,
                                                                  "tp2.json"))
        run.check(ok, f"17c: two ranks at tp = 2 over {TP2_BACKEND} on the "
                  f"one card ran (rc {proc.returncode}, {wall:.1f} s)"
                  f"{'' if ok else ': ' + err[-1500:]}")
        if not ok:
            return {"backend": TP2_BACKEND, "rc": proc.returncode}
        with open(os.path.join(d, "tp2.json")) as f:
            two = json.load(f)
    one, one_ms = _tp_single(TH, GPTConfig, torch, fields, TP_COMPARED)
    diff = max(abs(a - b) for a, b in zip(two["losses"], one))
    run.check(diff <= 2e-2 and two["world"] == 2
              and two["backend"] == TP2_BACKEND,
              f"17c: the global losses {[round(x, 4) for x in two['losses']]}"
              f" of 2 ranks ({two['backend']}) are within 2e-2 of the "
              f"world-1 run's {[round(x, 4) for x in one]} (worst "
              f"{diff:.3e})")
    want = {n: TP2_LAYERS * TP_COMPARED for n in TP_KERNELS}
    heads = TP_LLAMA["num_heads"] // 2
    run.check(two["launches"] == want and two["local_heads"] == [heads],
              f"17c: each rank launched {TP2_LAYERS} a step of each "
              f"causal_attention kernel ({two['launches']}) at "
              f"{two['local_heads']} local heads, {heads} expected")
    ms2 = float(np.median(two["step_ms"][1:]))
    coll = float(np.median(two["collective_ms"][1:]))
    print(f"17c: Llama-7B widths at {TP2_LAYERS} layers, B{TP_BATCH} "
          f"S{TP_SEQ}, tp = 2 + sp over {TP2_BACKEND}: {ms2:.1f} ms/step "
          f"(host clock, median of steps 2-{TP_COMPARED}), the collectives "
          f"{coll:.1f} ms of it; collective.host_staged "
          f"{two['host_staged']}; world 1 {one_ms:.1f} ms/step (CUDA "
          "events)", flush=True)
    return {"backend": TP2_BACKEND, "two_rank_losses": two["losses"],
            "world1_losses": one, "loss_abs_err": diff,
            "ms_per_step": ms2, "step_ms": two["step_ms"],
            "collective_ms": coll, "collective_ms_all": two["collective_ms"],
            "host_staged": two["host_staged"],
            "launches": two["launches"], "local_heads": two["local_heads"],
            "world1_ms_per_step": one_ms, "launcher_s": wall}


def drive_tensor_parallel(run, paddle, TH, GPTConfig, mods, cost_model,
                          torch):
    """Phase 17: 17a the primitives at world 1 over NCCL, 17b the Llama-7B
    width tp + sp step (16 layers) with and without collective_matmul, 17c
    two ranks at tp = 2 over gloo on the one card."""
    import paddle_tpu_torch.distributed as dist
    t_phase = time.perf_counter()
    paddle.set_device("gpu:0")
    out = {"allocated_at_start_gb": torch.cuda.memory_allocated() / 1e9}
    print(f"17: {out['allocated_at_start_gb']:.2f} GB allocated on the card "
          "by earlier phases", flush=True)
    t0 = time.perf_counter()
    single, single_ms = _tp_single(TH, GPTConfig, torch, TP_LLAMA,
                                   TP_COMPARED)
    print(f"17b single-device step: {[round(x, 4) for x in single]}, "
          f"{single_ms:.2f} ms/step ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    out["primitives_rel_err"] = check_tp_primitives(run, paddle, dist,
                                                    torch)
    print(f"17a: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out.update(drive_tp_gpt(run, paddle, dist, TH, GPTConfig, mods,
                            cost_model, torch, single, single_ms))
    print(f"17b: {time.perf_counter() - t0:.1f} s", flush=True)
    dist.destroy_process_group()
    t0 = time.perf_counter()
    out["two_ranks"] = drive_tp_two_ranks(run, TH, GPTConfig, torch)
    print(f"17c: {time.perf_counter() - t0:.1f} s", flush=True)
    out["phase_17_s"] = time.perf_counter() - t_phase
    print(f"tensor-parallel phase: {out['phase_17_s']:.1f} s", flush=True)
    return out


# Phase 18: pipelines at llama_tp_pp_sharding3.py's widths (TP_LLAMA: vocab
# 32000, h4096, 32 heads of 128, S2048; bf16, remat "names", fused CE) at
# 4 of its 32 layers in 2 stages (16, 17b's depth, took 71.9 s of a 1030 s
# script with phase 21, and 8 most of 101 s of 1044 s; the widths stay).
# The batch is B4 in 4 microbatches: the workload's full configuration
# (B = 2·dp = 2 at TP4 x PP2, 4 microbatches) is refused by the reference's
# own pipeline_microbatch (a batch of 2 does not split into 4), so the card
# runs the smallest batch its 4 microbatches divide.
PP_BATCH, PP_MICRO, PP_STAGES, PP_LAYERS = 4, 4, 2, 4
# 18a's schedules: (label, builder); 18b's pp_schedule values at 4 layers
PP_SCHEDULES = (("1F1B", "schedule_1f1b"), ("ZBH1", "schedule_zbh1"),
                ("VPP2", "schedule_interleaved"), ("ZB-V", "schedule_zbvpp"))
PP2_LAYERS, PP2_SCHEDULES, PP2_STEPS = 4, ("gpipe", "1f1b", "zbh1"), 3


def _pp_ids(torch, cfg):
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (PP_BATCH, TP_SEQ))).cuda()


def pp_expected_launches(kind, layers, micro):
    """causal_attention's launches (fwd, bwd) a step on a stage of
    ``layers`` layers, written down before the run. A forward cell runs
    each layer's forward once (no autograd); a fused B recomputes the stage
    forward (1 forward a layer; remat "names" saves the attention output,
    so its checkpoints recompute no attention) and back-propagates once (1
    backward); a zero-bubble B recomputes it without the checkpoints and
    back-propagates for the input gradient, and W back-propagates through
    the same graph again (2 backwards). GPipe runs each of a stage's
    microbatches once forward, keeping the graph, and once backward; a
    tick without a microbatch runs nothing."""
    if kind == "gpipe":
        return layers * micro, layers * micro
    if kind in ("zbh1", "ZBH1", "ZB-V"):
        return 2 * layers * micro, 2 * layers * micro
    return 2 * layers * micro, layers * micro


def drive_pp_schedules(run, TH, GPTConfig, torch):
    """18a: pp_schedule.run_schedule on the card in one process, every stage
    here (gpt_hybrid.schedule_value_and_grad): 1F1B, ZBH1, the interleaved
    schedule (v = 2) and ZB-V over the Llama-7B-width model at PP_LAYERS
    layers split in 2 stages, B4 S2048 in 4 microbatches, against the
    unpipelined single-device step's loss and gradients."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops.hopper import causal_attention as ca
    from paddle_tpu_torch.parallel import pp_schedule as PS
    cfg = GPTConfig(**dict(TP_LLAMA, num_layers=PP_LAYERS))
    L, m = cfg.num_layers, PP_MICRO
    pcfg = _tp_pcfg(TH, torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = TH.init_params(cfg, pcfg, gen, "cuda")
    ids = _pp_ids(torch, cfg)
    # the unpipelined single-device step: its loss and gradients
    ca.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base_loss, base_grads = TH._value_and_grad(params, (ids, ids), cfg, pcfg)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    base_launches = dict(ca.LAUNCHES)
    base_loss = float(base_loss)
    # kept on the host, brought back a layer at a time to compare: 6.7 GB
    # of the card freed for the schedules' peaks
    base = {k: g.cpu() for k, g in zip(TH._leaf_names(params), base_grads)}
    del base_grads
    print(f"18a unpipelined step: loss {base_loss:.5f}, {base_s:.2f} s, "
          f"launches {base_launches}", flush=True)
    out = {"unpipelined_loss": base_loss, "unpipelined_launches":
           base_launches, "schedules": {}}

    def one_step(sched):
        """Loss and gradients (by leaf name) of one step through the
        schedule, every stage here: the port's pipeline stage, head seed
        and embedding backward (gpt_hybrid.schedule_value_and_grad)."""
        loss, grads = TH.schedule_value_and_grad(params, (ids, ids), cfg,
                                                 pcfg, sched)
        return float(loss), dict(zip(TH._leaf_names(params), grads))

    for label, builder in PP_SCHEDULES:
        sched = getattr(PS, builder)(PP_STAGES, m, 2) if label == "VPP2" \
            else getattr(PS, builder)(PP_STAGES, m)
        want = pp_expected_launches(label, L, m)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        at_start = torch.cuda.memory_allocated()
        ca.reset_launch_counts()
        loss, grads = one_step(sched)
        torch.cuda.synchronize()
        launches = dict(ca.LAUNCHES)
        peak_gb = (torch.cuda.max_memory_allocated() - at_start) / 1e9
        rel = abs(loss - base_loss) / abs(base_loss)
        worst, worst_leaf = 0.0, None
        for k, g in grads.items():
            # a layer at a time: fc1_w's f32 temporaries are 4 GB whole
            ref = base[k]
            pairs = zip(g.unbind(0), ref.unbind(0)) if k.startswith(
                "blocks.") else [(g, ref)]
            diff = scale = 0.0
            for a, b in pairs:
                b = b.cuda().float()
                diff = max(diff, float((a - b).abs().max()))
                scale = max(scale, float(b.abs().max()))
            err = diff / max(scale, 1e-30)
            if err > worst:
                worst, worst_leaf = err, k
        del grads
        times = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            one_step(sched)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_step(sched)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(r[1] for r in _device_rows(prof))
        idle = max(0.0, 1 - busy / wall_ms)
        makespan, bubble = sched.simulate()
        res = {"loss": loss, "loss_rel_err": rel, "grad_rel_err": worst,
               "worst_leaf": worst_leaf, "launches": launches,
               "expected_launches": {TP_KERNELS[0]: want[0],
                                     TP_KERNELS[1]: want[1]},
               "ms_per_step": float(np.median(times)), "step_ms": times,
               "peak_activations": sched.peak_activations(),
               "peak_memory_gb": peak_gb, "idle_share": idle,
               "profiled_ms": wall_ms, "kernel_ms": busy,
               "bubble": bubble, "makespan": makespan}
        out["schedules"][label] = res
        print(f"18a {label}: loss {loss:.5f} (unpipelined {base_loss:.5f}, "
              f"rel {rel:.2e}), worst gradient {worst:.2e} of its scale "
              f"({worst_leaf}); launches {launches} (expected {want}); "
              f"{res['ms_per_step']:.2f} ms/step (CUDA events, median of 2: "
              f"{[round(t, 2) for t in times]}); peak_activations "
              f"{res['peak_activations']}, peak {peak_gb:.2f} GB above "
              f"the {at_start / 1e9:.2f} GB held; profiled {wall_ms:.2f} "
              f"ms wall, {busy:.2f} ms kernels, idle share {idle:.3f}; "
              f"simulated bubble {bubble:.3f}", flush=True)
        run.check(rel <= TOL["bfloat16"] and worst <= TOL["bfloat16"],
                  f"18a {label}: the loss ({rel:.2e}) and every gradient "
                  f"(worst {worst:.2e}, {worst_leaf}) within "
                  f"{TOL['bfloat16']} of the unpipelined step's scale")
        run.check(launches == {TP_KERNELS[0]: want[0],
                               TP_KERNELS[1]: want[1]},
                  f"18a {label}: causal_attention launched {launches}, "
                  f"expected fwd {want[0]}, bwd {want[1]}")
    del params, base
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase18b_worker(out_dir):
    """One rank of 18b, started by the port's launcher: gpt_hybrid's pp = 2
    step over gloo with the card's tensors for each of PP2_SCHEDULES; rank
    by rank, the losses, host-clock ms/step, causal_attention's launches and
    the pipeline hops (``collective.P2P_STATS``, ``HOST_STAGED``)."""
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.models import gpt_hybrid as TH
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops.hopper import causal_attention as ca
    paddle.set_device("gpu:0")
    dist.init_parallel_env(backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = GPTConfig(**dict(TP_LLAMA, num_layers=PP2_LAYERS))
    res = {"world": world, "backend": dist.get_backend()}
    for kind in PP2_SCHEDULES:
        pcfg = _tp_pcfg(TH, torch, pp=world, microbatches=PP_MICRO,
                        pp_schedule=kind)
        params, opt_state, step = TH.setup(cfg, pcfg, seed=0)
        batch = (_pp_ids(torch, cfg),) * 2
        ca.reset_launch_counts()
        C.P2P_STATS.clear()
        C.HOST_STAGED.clear()
        losses, step_ms = [], []
        for _ in range(PP2_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(params, opt_state, batch)[2]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        res[kind] = {"losses": losses, "step_ms": step_ms,
                     "launches": dict(ca.LAUNCHES),
                     "p2p": dict(C.P2P_STATS),
                     "host_staged": dict(C.HOST_STAGED)}
        del params, opt_state, step
    with open(os.path.join(out_dir, f"pp2.{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def drive_pp_two_ranks(run, TH, GPTConfig, torch):
    """18b: gpt_hybrid at pp = 2, two ranks on the one card over gloo (NCCL
    refuses two ranks on one device), through the launcher, against the
    world-1 single-device step of the same configuration."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=os.path.join(root, ".cache")) as d:
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "2", os.path.abspath(__file__),
             "--phase18b-worker", d],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        try:
            _, err = proc.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            _, err = proc.communicate()
        wall = time.perf_counter() - t0
        files = [os.path.join(d, f"pp2.{r}.json") for r in range(2)]
        ok = proc.returncode == 0 and all(map(os.path.exists, files))
        run.check(ok, f"18b: two ranks at pp = 2 over gloo on the one card "
                  f"ran (rc {proc.returncode}, {wall:.1f} s)"
                  f"{'' if ok else ': ' + err[-1500:]}")
        if not ok:
            return {"rc": proc.returncode}
        ranks = []
        for path in files:
            with open(path) as f:
                ranks.append(json.load(f))
    cfg = GPTConfig(**dict(TP_LLAMA, num_layers=PP2_LAYERS))
    params, opt_state, step = TH.setup(cfg, _tp_pcfg(TH, torch), seed=0)
    one, one_t = _timed_steps(torch, step, params, opt_state,
                              (_pp_ids(torch, cfg),) * 2, PP2_STEPS)
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    out = {"world1_losses": one, "world1_ms_per_step":
           float(np.median(one_t[1:])), "launcher_s": wall, "schedules": {}}
    per_rank = PP2_LAYERS // 2
    for kind in PP2_SCHEDULES:
        got = [r[kind] for r in ranks]
        diff = max(abs(a - b) for r in got for a, b in zip(r["losses"], one))
        want = pp_expected_launches(kind, per_rank, PP_MICRO)
        want = {TP_KERNELS[0]: want[0] * PP2_STEPS,
                TP_KERNELS[1]: want[1] * PP2_STEPS}
        run.check(diff <= 2e-2,
                  f"18b {kind}: the global losses "
                  f"{[round(x, 4) for x in got[0]['losses']]} of 2 ranks "
                  f"are within 2e-2 of the world-1 step's "
                  f"{[round(x, 4) for x in one]} (worst {diff:.3e})")
        run.check(all(r["launches"] == want for r in got),
                  f"18b {kind}: each rank launched "
                  f"{[r['launches'] for r in got]} causal_attention "
                  f"kernels over {PP2_STEPS} steps, expected {want}")
        res = {"loss_abs_err": diff,
               "losses": got[0]["losses"],
               "ms_per_step": [float(np.median(r["step_ms"][1:]))
                               for r in got],
               "launches": [r["launches"] for r in got],
               "expected_launches": want,
               "p2p": [r["p2p"] for r in got],
               "host_staged": [r["host_staged"] for r in got]}
        out["schedules"][kind] = res
        print(f"18b {kind}: Llama-7B widths at {PP2_LAYERS} layers "
              f"({per_rank} a stage), B{PP_BATCH} S{TP_SEQ} in {PP_MICRO} "
              f"microbatches, pp = 2 over gloo: losses "
              f"{[round(x, 4) for x in res['losses']]} (world 1 "
              f"{[round(x, 4) for x in one]}); ms/step by rank "
              f"{[round(x, 1) for x in res['ms_per_step']]} (host clock, "
              f"median of steps 2-{PP2_STEPS}; world 1 "
              f"{out['world1_ms_per_step']:.1f}); launches by rank "
              f"{res['launches']}; hops by rank {res['p2p']}; host-staged "
              f"{res['host_staged']}", flush=True)
    return out


def drive_pipeline(run, paddle, TH, GPTConfig, torch):
    """Phase 18: 18a run_schedule's four schedules on the card in one
    process, 18b gpt_hybrid at pp = 2 as two gloo ranks on the one card."""
    t_phase = time.perf_counter()
    paddle.set_device("gpu:0")
    out = {"allocated_at_start_gb": torch.cuda.memory_allocated() / 1e9,
           "batch": PP_BATCH, "microbatches": PP_MICRO,
           "layers": PP_LAYERS, "stages": PP_STAGES}
    t0 = time.perf_counter()
    out["run_schedule"] = drive_pp_schedules(run, TH, GPTConfig, torch)
    print(f"18a: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out["two_ranks"] = drive_pp_two_ranks(run, TH, GPTConfig, torch)
    print(f"18b: {time.perf_counter() - t0:.1f} s", flush=True)
    out["phase_18_s"] = time.perf_counter() - t_phase
    print(f"pipeline phase: {out['phase_18_s']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------- phase 19
# Expert parallelism and the semi-auto API over torch.distributed. The card
# holds one NCCL rank (19a, 19b, 19e, 19f: the code N ranks run, at world 1)
# and gloo ranks (19c, 19d: NCCL refuses two ranks on one device; their
# all-to-alls of the card's tensors go through the host, counted in
# collective.HOST_STAGED).
# 19b: benchmarks/workloads/moe_ep.py:29-38's full configuration, phase
# 10b's MOE_PATH (vocab 50304, h1024, 24 layers, 8 heads of 128, B4 S1024,
# E = 2, bf16, remat "names", fused CE, ZeRO-1) through the ep branch.
# 19c, 19d: the same widths at 4 layers with E = 4 (two experts a dp rank),
# B4 S1024 over the job; depth is the only cut (six ranks share the card
# and its host's eight cores beside this process).
EP_STEPS = 3
EP_SMALL_LAYERS, EP_SMALL_EXPERTS, EP_ZB_MICRO = 4, 4, 2
# the ep branch's all-to-alls a layer: 2 forward, 2 backward; none sits
# inside a checkpoint, so remat re-issues none
EP_ALLTOALLS_PER_LAYER = 4


def _ep_pcfg(TH, torch, **fields):
    return TH.ParallelConfig(**{
        "remat": True, "remat_policy": "names", "fused_ce": True,
        "zero1": True, "param_dtype": torch.bfloat16,
        "compute_dtype": torch.bfloat16, **fields})


def _ep_ids(torch, cfg, batch, seq):
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()


def _single_losses(TH, GPTConfig, torch, fields, experts, batch, seq,
                   steps):
    """The single-device step's losses (no process group may exist)."""
    cfg = GPTConfig(**fields)
    params, opt_state, step = TH.setup(
        cfg, _ep_pcfg(TH, torch, num_experts=experts), seed=0)
    ids = _ep_ids(torch, cfg, batch, seq)
    losses = [float(step(params, opt_state, (ids, ids))[2])
              for _ in range(steps)]
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _alltoall_counts(C):
    return dict(C.ALLTOALL_STATS), dict(C.HOST_STAGED)


def _launch_check(launches, want_fwd, want_bwd):
    """One attention tier launched: its forward kernel ``want_fwd`` times,
    each of its backward kernels ``want_bwd`` times, no other kernel."""
    used = {n: c for n, c in launches.items() if c}
    fwd = [n for n in used if n.endswith("_fwd")]
    return len(fwd) == 1 and all(
        c == (want_fwd if n in fwd else want_bwd) for n, c in used.items())


def check_ep_primitives(run, paddle, TH, world, torch):
    """19a: global_scatter/global_gather and the ep branch's all-to-all and
    MoE FFN at world 1 over NCCL, f32 and bf16, each against its plain form
    (the reference's world-1 value: the exchange with itself; the MoE FFN
    on one device, gpt_hybrid._moe_ffn)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.utils import (global_gather,
                                                    global_scatter)
    from paddle_tpu_torch.models.gpt_manual_tp import moe_ffn_manual_ep
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(19)
    h, m, e, b, s = 1024, 4096, 2, 4, 1024
    C.HOST_STAGED.clear()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * scale).to(dtype)
        x = randn(b * s, h)
        counts = [1024, 2048, 1024]
        sc = global_scatter(paddle.Tensor(x), counts, counts, group=world)
        back = global_gather(sc, counts, counts, group=world)
        xs = randn(e, b * s, h)
        a2a = C._AllToAll.apply(xs, world, 0, 1, True)
        lp = {"gate_w": randn(h, e, scale=0.02),
              "fc1_w": randn(e, h, m, scale=0.02),
              "fc1_b": randn(e, m, scale=0.02),
              "fc2_w": randn(e, m, h, scale=0.02),
              "fc2_b": randn(e, h, scale=0.02)}
        pcfg = _ep_pcfg(TH, torch, num_experts=e, remat=False)
        hx = randn(b, s, h)
        got = moe_ffn_manual_ep(hx, lp, e, world, pcfg)
        want = TH._moe_ffn(hx, lp, pcfg)
        torch.cuda.synchronize()
        err = max_err(got, want)[1]
        exact = (bool(torch.equal(sc._data, x))
                 and bool(torch.equal(back._data, x))
                 and bool(torch.equal(a2a, xs)))
        run.check(exact and err <= TOL[name],
                  f"19a {name}: global_scatter, global_gather and the ep "
                  f"all-to-all over NCCL at world 1 give their plain form "
                  f"exactly ({exact}); the ep MoE FFN ({e} experts, "
                  f"B{b} S{s} h{h}) is within {TOL[name]} of the "
                  f"one-device FFN: {err:.3e}")
        out[name] = {"exchange_exact": exact, "moe_ffn_rel_err": err}
    run.check(not C.HOST_STAGED,
              f"19a: nothing went through the host: {dict(C.HOST_STAGED)}")
    return out


def drive_ep_gpt(run, TH, GPTConfig, mods, cost_model, torch, single):
    """19b: moe_ep's full configuration through the ep branch at world 1
    over NCCL, against the single-device step (phase 10b's)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.observability import metrics as met
    label, fields, batch, seq, tier, kernels, *_ = MOE_PATH
    cfg = GPTConfig(**fields)
    L = cfg.num_layers
    pcfg = _ep_pcfg(TH, torch, num_experts=MOE_EXPERTS)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, step = TH.setup(cfg, pcfg, seed=0)
    ids = _ep_ids(torch, cfg, batch, seq)
    torch.cuda.synchronize()
    for mod in mods:
        mod.reset_launch_counts()
    C.ALLTOALL_STATS.clear()
    C.HOST_STAGED.clear()
    losses = [float(step(params, opt_state, (ids, ids))[2])
              for _ in range(EP_STEPS)]
    torch.cuda.synchronize()
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    a2a, staged = _alltoall_counts(C)
    times = []
    for _ in range(EP_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(params, opt_state, (ids, ids))[2]
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
    ms = float(np.median(times))
    tok_s = batch * seq / (ms / 1e3)
    fpt = moe_flops_per_token(cfg, seq, MOE_EXPERTS, MOE_EXPERTS,
                              cost_model)
    mfu = cost_model.mfu(tok_s, fpt, "H100")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, (ids, ids))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    nccl_ops = sorted({e.key for e in prof.key_averages()
                       if e.key.startswith("nccl:")})
    nccl_ms = sum(r[1] for r in _nccl_rows(rows))
    busy = sum(r[1] for r in rows) - nccl_ms
    idle = max(0.0, 1 - busy / wall_ms)
    n = min(len(single), EP_STEPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[:n], single[:n]))
    want_a2a = EP_ALLTOALLS_PER_LAYER * L * EP_STEPS
    print(f"19b {label} ({MOE_EXPERTS} experts) through the ep branch at "
          f"world 1 over NCCL: losses {[round(x, 4) for x in losses]}; "
          f"single-device {[round(x, 4) for x in single[:n]]}", flush=True)
    run.check(rel <= TOL["bfloat16"],
              f"19b: the ep branch's {n} losses equal the single-device "
              f"step's within {TOL['bfloat16']} relative: worst {rel:.3e}")
    run.check(launches == {k: L * EP_STEPS if k in kernels else 0
                           for k in launches},
              f"19b: {L} launches a step of each of {list(kernels)} over "
              f"{EP_STEPS} steps, no other attention kernel: {launches}")
    run.check(a2a.get("calls") == want_a2a and not staged,
              f"19b: {EP_ALLTOALLS_PER_LAYER} all-to-alls a layer a step "
              f"({want_a2a} over {EP_STEPS} steps, written down before the "
              f"run), none through the host: {a2a}, {staged}")
    run.check(10.0 <= losses[0] <= 11.5 and losses[-1] < losses[0]
              and all(map(math.isfinite, losses)),
              f"19b: step-0 loss {losses[0]:.4f} in [10, 11.5] and the loss "
              f"falls to {losses[-1]:.4f}")
    print(f"19b: {ms:.2f} ms/step (device events, median of {EP_STEPS}, "
          f"spread {max(times) - min(times):.2f}); {tok_s:.1f} tokens/s, MFU "
          f"{mfu:.4f} at {fpt:.4e} FLOP/token (the dense dispatch's); peak "
          f"memory {peak_gb:.2f} GB; profiled step {wall_ms:.2f} ms wall, "
          f"{busy:.2f} ms kernel time, NCCL {nccl_ms:.3f} ms ({nccl_ops}), "
          f"idle share {idle:.3f}; all-to-alls {a2a}", flush=True)
    for key, kms, count in rows[:8]:
        print(f"  {kms:9.3f} ms {count:6d}x  {key[:100]}")
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "single_device_losses": single[:n],
            "loss_rel_err": rel, "ms_per_step": ms,
            "ms_per_step_spread": max(times) - min(times),
            "tokens_per_s": tok_s, "mfu": mfu, "flops_per_token": fpt,
            "peak_memory_gb": peak_gb, "profiled_ms": wall_ms,
            "kernel_ms": busy, "nccl_ms": nccl_ms, "nccl_ops": nccl_ops,
            "idle_share": idle, "alltoall": a2a,
            "expected_alltoalls": want_a2a, "launches": launches}


def phase19_worker(out_dir, kind):
    """One rank of 19c ("dp2": dp = 2) or 19d ("zbh1": dp2 x pp2 under ZBH1,
    the manual-ep route), started by the port's launcher over gloo with the
    card's tensors: EP_STEPS steps of the small MoE GPT; rank by rank the
    losses, host-clock ms/step, attention launches and all-to-alls."""
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.models import gpt_hybrid as TH
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops.hopper import (blocked_flash, causal_attention,
                                             flash_attention,
                                             simple_attention,
                                             simple_attention2)
    mods = (simple_attention, causal_attention, blocked_flash,
            simple_attention2, flash_attention)
    paddle.set_device("gpu:0")
    dist.init_parallel_env(backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    label, fields, batch, seq, *_ = MOE_PATH
    cfg = GPTConfig(**dict(fields, num_layers=EP_SMALL_LAYERS))
    extra = {"dp": 2} if kind == "dp2" else {
        "dp": 2, "pp": 2, "microbatches": EP_ZB_MICRO, "pp_schedule": "zbh1"}
    pcfg = _ep_pcfg(TH, torch, num_experts=EP_SMALL_EXPERTS, **extra)
    params, opt_state, step = TH.setup(cfg, pcfg, seed=0)
    ids = _ep_ids(torch, cfg, batch, seq)
    for mod in mods:
        mod.reset_launch_counts()
    C.ALLTOALL_STATS.clear()
    C.HOST_STAGED.clear()
    losses, step_ms = [], []
    for _ in range(EP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(params, opt_state, (ids, ids))[2]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    a2a, staged = _alltoall_counts(C)
    res = {"world": world, "losses": losses, "step_ms": step_ms,
           "launches": {n: c for mod in mods
                        for n, c in mod.LAUNCHES.items()},
           "alltoall": a2a, "host_staged": staged,
           "grid": [TH._grid(pcfg).dp_rank, TH._grid(pcfg).pp_rank]}
    with open(os.path.join(out_dir, f"ep.{kind}.{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def start_ep_ranks():
    """19c and 19d's jobs, started together through the launcher: (the
    directory, {kind: (process, ranks, start time)})."""
    root = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp(dir=os.path.join(root, ".cache"))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    jobs = {}
    for kind, n in (("dp2", 2), ("zbh1", 4)):
        jobs[kind] = (subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", str(n), os.path.abspath(__file__),
             "--phase19-worker", d, kind],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True),
            n, time.perf_counter())
    return d, jobs


def finish_ep_ranks(run, d, jobs, single):
    """19c and 19d: waits for the two jobs and holds each against the
    world-1 step with all four experts (``single``)."""
    out = {}
    L = EP_SMALL_LAYERS
    stage = L // 2
    fw, bw = pp_expected_launches("zbh1", stage, EP_ZB_MICRO)
    want = {
        "dp2": (L * EP_STEPS, L * EP_STEPS,
                EP_ALLTOALLS_PER_LAYER * L * EP_STEPS),
        # a zbh1 stage: per layer a microbatch, the F cell's 2 all-to-alls,
        # B's recompute and input backward 4, W's weight backward 2
        "zbh1": (fw * EP_STEPS, bw * EP_STEPS,
                 8 * stage * EP_ZB_MICRO * EP_STEPS),
    }
    try:
        for kind, (proc, n, t0) in jobs.items():
            try:
                _, err = proc.communicate(timeout=400)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)
                _, err = proc.communicate()
            wall = time.perf_counter() - t0
            files = [os.path.join(d, f"ep.{kind}.{r}.json")
                     for r in range(n)]
            ok = proc.returncode == 0 and all(map(os.path.exists, files))
            tag = {"dp2": "19c dp = 2", "zbh1": "19d dp2 x pp2 zbh1"}[kind]
            run.check(ok, f"{tag}: {n} gloo ranks on the one card ran (rc "
                      f"{proc.returncode}, {wall:.1f} s)"
                      f"{'' if ok else ': ' + err[-1500:]}")
            if not ok:
                out[kind] = {"rc": proc.returncode}
                continue
            ranks = []
            for path in files:
                with open(path) as f:
                    ranks.append(json.load(f))
            diff = max(abs(a - b) for r in ranks
                       for a, b in zip(r["losses"], single))
            wf, wb, wa = want[kind]
            run.check(diff <= 2e-2,
                      f"{tag}: the global losses "
                      f"{[round(x, 4) for x in ranks[0]['losses']]} are "
                      f"within 2e-2 of the world-1 step's with all "
                      f"{EP_SMALL_EXPERTS} experts "
                      f"{[round(x, 4) for x in single]} (worst {diff:.3e})")
            run.check(all(_launch_check(r["launches"], wf, wb)
                          for r in ranks),
                      f"{tag}: each rank launched one attention tier, its "
                      f"forward {wf} and each backward kernel {wb} times "
                      f"over {EP_STEPS} steps (written down before the run): "
                      f"{[{k: c for k, c in r['launches'].items() if c} for r in ranks]}")
            run.check(all(r["alltoall"].get("calls") == wa for r in ranks),
                      f"{tag}: {wa} all-to-alls a rank over {EP_STEPS} steps: "
                      f"{[r['alltoall'] for r in ranks]}")
            res = {"losses": ranks[0]["losses"], "loss_abs_err": diff,
                   "ms_per_step": [float(np.median(r["step_ms"][1:]))
                                   for r in ranks],
                   "launches": [{k: c for k, c in r["launches"].items() if c}
                                for r in ranks],
                   "expected_launches": [wf, wb],
                   "alltoall": [r["alltoall"] for r in ranks],
                   "expected_alltoalls": wa,
                   "host_staged": [r["host_staged"] for r in ranks],
                   "launcher_s": wall}
            out[kind] = res
            print(f"{tag}: h1024 at {L} layers, {EP_SMALL_EXPERTS} experts, "
                  f"B{MOE_PATH[2]} S{MOE_PATH[3]} over {n} gloo ranks: "
                  f"losses {[round(x, 4) for x in res['losses']]}; ms/step "
                  f"by rank {[round(x, 1) for x in res['ms_per_step']]} "
                  f"(host clock, median of steps 2-{EP_STEPS}); all-to-alls "
                  f"by rank {res['alltoall']}; host-staged "
                  f"{res['host_staged']}; launches {res['launches']}",
                  flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def _medium_layer_gpt(paddle, GPTConfig, GPTForCausalLM, torch):
    """Phase 14c's Layer GPT at MEDIUM's widths (GPT-2's initialisation,
    bf16) and its AdamW(1e-4, multi_precision)."""
    cfg = GPTConfig(**MEDIUM)
    paddle.seed(0)
    model = GPTForCausalLM(cfg)
    _gpt_normal_init(model, 19, torch)
    model.bfloat16()
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    return cfg, model, opt


def _timed_calls(torch, fa, fn, n):
    """(values, ms by CUDA events, library launches) of n calls of fn."""
    vals, times, launches = [], [], []
    for _ in range(n):
        fa.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        v = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        vals.append(float(v))
        launches.append(dict(fa.LAUNCHES))
    return vals, times, launches


def drive_dist_model(run, paddle, dist, GPTConfig, GPTForCausalLM, fa,
                     torch, fit_ms=None):
    """19e: the Layer GPT at GPT-3 Medium's widths (phase 13's MEDIUM),
    bf16, AdamW(1e-4, multi_precision), B4 S2048: eager steps, then the
    same model through shard_tensor (Replicate at world 1) and
    to_static -> DistModel over NCCL."""
    b, s = MEDIUM_BATCH, MEDIUM_SEQ
    L = MEDIUM["num_layers"]
    loss_fn = _lm_loss(paddle)
    ids = paddle.to_tensor(np.random.RandomState(19).randint(
        0, MEDIUM["vocab_size"], (b, s)))
    cfg, model, opt = _medium_layer_gpt(paddle, GPTConfig, GPTForCausalLM,
                                         torch)

    def eager():
        loss = loss_fn(model(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    want, etimes, _ = _timed_calls(torch, fa, eager, EP_STEPS)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, opt = _medium_layer_gpt(paddle, GPTConfig, GPTForCausalLM,
                                         torch)
    mesh = dist.ProcessMesh([0], dim_names=["dp"])
    for p in model.parameters():
        dist.shard_tensor(p, mesh, [dist.Replicate()])
    placed = all(p.placements == [dist.Replicate()]
                 for p in model.parameters())
    dm = dist.to_static(model, None, loss_fn, dist.shard_optimizer(opt))
    got, times, launches = _timed_calls(torch, fa, lambda: dm(ids, ids),
                                        EP_STEPS)
    rel = max(abs(a - w) / abs(w) for a, w in zip(got, want))
    lib = {n: L if n in fa.LAUNCHES else 0 for n in launches[0]}
    run.check(placed and rel <= TOL["bfloat16"]
              and 10.0 <= got[0] <= 11.5,
              f"19e: DistModel's losses {[round(x, 4) for x in got]} equal "
              f"the eager Layer GPT's {[round(x, 4) for x in want]} within "
              f"{TOL['bfloat16']} relative (worst {rel:.3e}), the first near "
              f"ln(50304) = 10.826, every parameter Replicate on the mesh")
    run.check(all(x == lib for x in launches),
              f"19e: {L} launches a step of each library kernel: "
              f"{launches}")
    ms = float(np.median(times[1:]))
    ems = float(np.median(etimes[1:]))
    print(f"19e: DistModel {ms:.2f} ms/step (device events, median of "
          f"steps 2-{EP_STEPS}) beside the eager steps' {ems:.2f} just "
          f"before and phase 13b's Model.fit "
          f"{fit_ms if fit_ms is None else round(fit_ms, 2)}", flush=True)
    del dm, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": got, "eager_losses": want, "loss_rel_err": rel,
            "ms_per_step": ms, "eager_ms_per_step": ems,
            "model_fit_ms_per_step": fit_ms, "launches": launches[0]}


def drive_engine(run, paddle, GPTConfig, GPTForCausalLM, fa, torch,
                 eager_losses, dist_ms, flagship_ms=None):
    """19f: auto_parallel.Engine(...).fit on 19e's model at world 1, the
    Planner's predictions beside the measured times, and auto_tuner.tune
    over the world-1 candidates with a trials file in a temporary
    directory."""
    from paddle_tpu_torch.distributed import auto_tuner
    from paddle_tpu_torch.distributed.auto_parallel import (Engine,
                                                            ModelSpec,
                                                            Planner)
    b, s = MEDIUM_BATCH, MEDIUM_SEQ
    L = MEDIUM["num_layers"]
    ids = paddle.to_tensor(np.random.RandomState(19).randint(
        0, MEDIUM["vocab_size"], (b, s)))
    cfg, model, opt = _medium_layer_gpt(paddle, GPTConfig, GPTForCausalLM,
                                         torch)
    engine = Engine(model, _lm_loss(paddle), opt)
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = engine.fit([(ids, ids)] * EP_STEPS, epochs=1, batch_size=b)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    plan = engine._plan.short()
    mean = float(np.mean(eager_losses))
    rel = abs(hist[0]["loss"] - mean) / mean
    run.check(plan.startswith("dp1xtp1xpp1") and rel <= TOL["bfloat16"],
              f"19f: Engine.fit planned {plan} at world 1 and its epoch's "
              f"mean loss {hist[0]['loss']:.4f} equals the eager steps' "
              f"{mean:.4f} within {TOL['bfloat16']} (relative {rel:.3e})")
    run.check(launches == {n: L * EP_STEPS for n in launches},
              f"19f: {L} launches a step of each library kernel over "
              f"{EP_STEPS} steps: {launches}")
    planner = Planner("H100")
    flagship = ModelSpec.gpt(1.3e9, 24, 2048, 16, 1024, 50304)
    medium = ModelSpec.from_config(cfg)

    def predicted(spec, batch, remat):
        c = next(c for c in planner.plan(spec, 1, batch, top_k=8)
                 if c.remat == remat)
        return c.est_step_s * 1e3
    pred = {"flagship_remat_ms": predicted(flagship, 4, True),
            "medium_noremat_ms": predicted(medium, b, False)}
    print(f"19f: Engine.fit {plan}, {EP_STEPS} steps in {fit_s:.2f} s, "
          f"losses by epoch {hist}; the Planner (H100, mfu "
          f"{planner.mfu:.4f}) predicts {pred['flagship_remat_ms']:.2f} "
          f"ms/step for phase 4's flagship (measured "
          f"{flagship_ms if flagship_ms is None else round(flagship_ms, 2)})"
          f" and {pred['medium_noremat_ms']:.2f} for 19e's model (measured "
          f"{dist_ms:.2f})", flush=True)
    runs = []

    def run_fn(c):
        runs.append(c.key)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(2):
            engine._step(engine._rows(ids), engine._rows(ids))
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 2e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trials.jsonl")
        cands = auto_tuner.generate_candidates(1, L, b, num_heads=16)
        best = auto_tuner.tune(run_fn, cands, verbose=False,
                               trials_path=path)
        again = auto_tuner.tune(run_fn, auto_tuner.generate_candidates(
            1, L, b, num_heads=16), verbose=False, trials_path=path)
    run.check(best.key == again.key and len(runs) == 1
              and best.time_s > 0,
              f"19f: auto_tuner.tune measured {runs} ({best.time_s * 1e3:.2f}"
              f" ms/step) and the second sweep warm-started from the trials "
              f"file")
    del engine, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"plan": plan, "history": hist, "fit_s": fit_s,
            "loss_rel_err": rel, "launches": launches,
            "planner_mfu": planner.mfu, "predicted": pred,
            "measured_flagship_ms": flagship_ms,
            "measured_medium_ms": dist_ms, "tuned": best.key,
            "tuned_ms_per_step": best.time_s * 1e3}


def drive_phase19(run, paddle, TH, GPTConfig, GPTForCausalLM, mods, fa,
                  cost_model, torch, moe=None, flagship=None, fit=None):
    """Phase 19: the gloo jobs of 19c and 19d start first and run while this
    process computes their world-1 reference; then 19a, 19b, 19e and 19f
    over NCCL at world 1, once the jobs have left the card."""
    import paddle_tpu_torch.distributed as dist
    t_phase = time.perf_counter()
    paddle.set_device("gpu:0")
    if dist.is_initialized():
        dist.destroy_process_group()
    d, jobs = start_ep_ranks()
    label, fields, batch, seq, *_ = MOE_PATH
    small = _single_losses(TH, GPTConfig, torch,
                           dict(fields, num_layers=EP_SMALL_LAYERS),
                           EP_SMALL_EXPERTS, batch, seq, EP_STEPS)
    t0 = time.perf_counter()
    ep = {"small_world1_losses": small}
    ep.update(finish_ep_ranks(run, d, jobs, small))
    print(f"19c+19d: {time.perf_counter() - t0:.1f} s after the world-1 "
          f"reference", flush=True)
    single = moe["losses"] if moe is not None else _single_losses(
        TH, GPTConfig, torch, fields, MOE_EXPERTS, batch, seq, EP_STEPS)
    world = dist.init_parallel_env()
    t0 = time.perf_counter()
    ep["primitives"] = check_ep_primitives(run, paddle, TH, world, torch)
    print(f"19a: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ep["moe_ep"] = drive_ep_gpt(run, TH, GPTConfig, mods, cost_model, torch,
                                single)
    print(f"19b: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ap = {"dist_model": drive_dist_model(
        run, paddle, dist, GPTConfig, GPTForCausalLM, fa, torch,
        fit["ms_per_step"] if fit else None)}
    print(f"19e: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ap["engine"] = drive_engine(
        run, paddle, GPTConfig, GPTForCausalLM, fa, torch,
        ap["dist_model"]["eager_losses"], ap["dist_model"]["ms_per_step"],
        flagship["ms_per_step"] if flagship else None)
    print(f"19f: {time.perf_counter() - t0:.1f} s", flush=True)
    dist.destroy_process_group()
    ep["phase_19_s"] = ap["phase_19_s"] = time.perf_counter() - t_phase
    print(f"expert/auto parallel phase: {ep['phase_19_s']:.1f} s",
          flush=True)
    return ep, ap


# ---------------------------------------------------------------- phase 20
# 20b's configuration: the layer widths of PaddleRec's Criteo DNN
# (models/rank/dnn): 26 sparse slots of one id hashed into 1,000,001 ids,
# embedding dim 9, 13 dense features, an MLP 247 -> 512 -> 256 -> 128 -> 32
# -> 1 with a sigmoid cross-entropy loss; 2^14 rows of ids drawn from a Zipf
# law of exponent 1.1 (2^15 cut to half, to fit the phase's time), B512,
# one pass of 32 steps, then an evaluation pass
CTR_IDS, CTR_DIM, CTR_SLOTS, CTR_DENSE = 1000001, 9, 26, 13
CTR_MLP = (CTR_SLOTS * CTR_DIM + CTR_DENSE, 512, 256, 128, 32, 1)
CTR_ROWS, CTR_BATCH, CTR_ZIPF = 1 << 14, 512, 1.1
CTR_PARSE_ROWS = 4096        # the head the Python parser reads
CTR_GEMMS = 3 * (len(CTR_MLP) - 1)   # a Linear's forward and 2 gradients
CTR_LR = 1e-3                # PaddleRec dnn's Adam learning rate
CTR_CHECK_STEPS = 4          # steps held against the CPU's plain path
CTR_TOL = 1e-5               # f32, FLAGS_matmul_precision "highest"
CTR_SERVERS = 2
# table ids: the card's pair, then the CPU check's pair (same seeds)
CTR_SPARSE, CTR_DENSE_T, CPU_SPARSE, CPU_DENSE_T = 0, 1, 2, 3
# 20a: phase 12's ResNet-50 batch (B256, 3 x 32 x 32 f32), a batch of
# ImageNet-sized samples (B64, 3 x 224 x 224 f32: io's collation takes the
# native collate there, np.stack at phase 12's), the TCPStore clients and
# the ops each client times
COLLATE_BATCH, COLLATE_SHAPE = 256, (3, 32, 32)
COLLATE_BIG_BATCH, COLLATE_BIG_SHAPE = 64, (3, 224, 224)
STORE_CLIENTS, STORE_OPS, STORE_BARRIERS = 2, 2000, 200
TRACER_SPANS = 100000
# 20d: the Layer GPT at MEDIUM's widths in two TaskNode stages
FE_SPLIT, FE_MICRO = 12, 4
# 20e: round trips timed; the large call's bytes
RPC_CALLS, RPC_BIG_BYTES = 200, 4 << 20
# 20f: the profiler's window over 4 steps (closed, ready, 2 recorded),
# repeated; then a profiler without a scheduler over 2 steps
PROF_STEPS, PROF_WINDOWS, PROF_PLAIN_STEPS = 4, 2, 2


def _ms_median(xs):
    return float(np.median(xs)) * 1e3


def _standalone_native():
    """paddle_tpu_torch/native loaded from its file alone (no torch): the
    TCPStore clients of 20a start in a fraction of a second."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "paddle_tpu_torch", "native", "__init__.py")
    spec = importlib.util.spec_from_file_location("paddle_native_alone",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase20a_client(port, rank, out):
    """A TCPStore client of 20a: times set, get and add over STORE_OPS
    calls each and STORE_BARRIERS barriers of the two clients."""
    native = _standalone_native()
    st = native.TCPStore("127.0.0.1", int(port), world_size=STORE_CLIENTS)
    val = b"x" * 64
    st.barrier("start")
    res = {}
    for name, fn in (("set", lambda i: st.set(f"k{rank}/{i}", val)),
                     ("get", lambda i: st.get(f"k{rank}/{i}")),
                     ("add", lambda i: st.add(f"c{rank}", 1))):
        t0 = time.perf_counter()
        for i in range(STORE_OPS):
            fn(i)
        res[name] = (time.perf_counter() - t0) / STORE_OPS * 1e6
    t0 = time.perf_counter()
    for _ in range(STORE_BARRIERS):
        st.barrier("loop")
    res["barrier"] = (time.perf_counter() - t0) / STORE_BARRIERS * 1e6
    res["count"] = int(st.get(f"c{rank}"))
    st.close()
    with open(out, "w") as f:
        json.dump(res, f)


def drive_native(run, paddle, torch):
    """20a: the native collate on phase 12's ResNet-50 batch against
    np.stack, the fused u8 HWC -> f32 CHW transform against its numpy form,
    TCPStore set/get/add/barrier from two client processes, and the
    tracer's cost a span."""
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch import native
    from paddle_tpu_torch import profiler
    out = {}
    t0 = time.perf_counter()
    native.build()
    out["build_s"] = time.perf_counter() - t0
    rs = np.random.RandomState(20)
    batch = [rs.randn(*COLLATE_SHAPE).astype(np.float32)
             for _ in range(COLLATE_BATCH)]

    def timed(fn, n=5):
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            r = fn()
            ts.append(time.perf_counter() - t)
        return r, _ms_median(ts)
    got, out["collate_ms"] = timed(lambda: native.collate(batch))
    want, out["np_stack_ms"] = timed(lambda: np.stack(batch))
    run.check(got.dtype == want.dtype and np.array_equal(got, want),
              f"20a: native.collate of {COLLATE_BATCH} x {COLLATE_SHAPE} f32 "
              f"bit-equal to np.stack ({out['collate_ms']:.3f} ms against "
              f"{out['np_stack_ms']:.3f})")
    big = [rs.randn(*COLLATE_BIG_SHAPE).astype(np.float32)
           for _ in range(COLLATE_BIG_BATCH)]
    got, out["collate_big_ms"] = timed(lambda: native.collate(big))
    want, out["np_stack_big_ms"] = timed(lambda: np.stack(big))
    gate = pio.NATIVE_COLLATE_MIN_BYTES
    run.check(np.array_equal(got, want) and batch[0].nbytes < gate
              <= big[0].nbytes,
              f"20a: native.collate of {COLLATE_BIG_BATCH} x "
              f"{COLLATE_BIG_SHAPE} f32 bit-equal to np.stack "
              f"({out['collate_big_ms']:.3f} ms against "
              f"{out['np_stack_big_ms']:.3f}); io's gate ({gate} B a "
              f"sample) sends these to the native collate, phase 12's "
              f"({batch[0].nbytes} B) to np.stack")
    del big, got, want
    imgs = [rs.randint(0, 256, COLLATE_SHAPE[1:] + COLLATE_SHAPE[:1],
                       dtype=np.uint8) for _ in range(COLLATE_BATCH)]
    mean, std = (0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)
    got, out["u8_chw_ms"] = timed(
        lambda: native.u8hwc_to_f32chw_batch(imgs, mean, std))
    want, out["u8_chw_numpy_ms"] = timed(
        lambda: native.u8hwc_to_f32chw_batch_py(imgs, mean, std))
    err = float(np.abs(got - want).max())
    run.check(got.shape == (COLLATE_BATCH,) + COLLATE_SHAPE and err <= 1e-5,
              f"20a: u8 HWC -> f32 CHW of {COLLATE_BATCH} images within 1e-5 "
              f"of its numpy form (max err {err:.2e}; {out['u8_chw_ms']:.3f} "
              f"ms against {out['u8_chw_numpy_ms']:.3f})")
    port = _free_port()
    master = native.TCPStore("127.0.0.1", port, is_master=True)
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase20a-client",
             str(port), str(r), os.path.join(d, f"{r}.json")])
            for r in range(STORE_CLIENTS)]
        codes = [p.wait(timeout=120) for p in procs]
        res = [json.load(open(os.path.join(d, f"{r}.json")))
               if c == 0 else None for r, c in enumerate(codes)]
    master.close()
    ok = all(r is not None and r["count"] == STORE_OPS for r in res)
    run.check(ok, f"20a: {STORE_CLIENTS} TCPStore clients ran {STORE_OPS} "
                  f"set/get/add and {STORE_BARRIERS} barriers each (exit "
                  f"codes {codes})")
    if ok:
        out["store_us"] = {k: float(np.mean([r[k] for r in res]))
                           for k in ("set", "get", "add", "barrier")}
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU])
    prof.start()
    t0 = time.perf_counter()
    for _ in range(TRACER_SPANS):
        with profiler.RecordEvent("span"):
            pass
    on = (time.perf_counter() - t0) / TRACER_SPANS * 1e6
    prof.stop()
    spans = sum(1 for s in prof._all_spans() if s.name == "span")
    t0 = time.perf_counter()
    for _ in range(TRACER_SPANS):
        with profiler.RecordEvent("span"):
            pass
    off = (time.perf_counter() - t0) / TRACER_SPANS * 1e6
    run.check(spans == TRACER_SPANS,
              f"20a: the native tracer kept {spans} of {TRACER_SPANS} spans")
    out["tracer_us_per_span"] = {"recording": on, "not_recording": off}
    print(f"20a: collate {out['collate_ms']:.3f} ms (np.stack "
          f"{out['np_stack_ms']:.3f}), at {COLLATE_BIG_SHAPE} "
          f"{out['collate_big_ms']:.3f} ms (np.stack "
          f"{out['np_stack_big_ms']:.3f}), u8->f32 CHW {out['u8_chw_ms']:.3f} ms "
          f"(numpy {out['u8_chw_numpy_ms']:.3f}), TCPStore us "
          f"{out.get('store_us')}, RecordEvent {on:.3f} us a span "
          f"recording, {off:.3f} not", flush=True)
    return out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ctr_data(path, seed):
    """A MultiSlot file of CTR_ROWS rows: 26 slots of one id (Zipf(1.1)
    draws folded into the id space, each slot at its own offset), 13 dense
    features (multiples of 1/1024 in [0, 8), exact in f32 and in 12
    digits) and a label from
    a logistic model of the dense features and the first slot's id. Returns
    the distinct ids."""
    rs = np.random.RandomState(seed)
    z = rs.zipf(CTR_ZIPF, (CTR_ROWS, CTR_SLOTS)) - 1
    ids = (z % CTR_IDS + np.arange(CTR_SLOTS) * (CTR_IDS // CTR_SLOTS)) \
        % CTR_IDS
    dense = rs.randint(0, 8192, (CTR_ROWS, CTR_DENSE)) / 1024.0
    logit = (dense - 4.0) @ rs.randn(CTR_DENSE) / 4.0 + \
        np.where(ids[:, 0] % 2 == 0, 1.0, -1.0)
    label = (rs.rand(CTR_ROWS) < 1.0 / (1.0 + np.exp(-logit))).astype(
        np.int64)
    row = " ".join(["1 %d"] * CTR_SLOTS + [str(CTR_DENSE)]
                   + ["%.12g"] * CTR_DENSE + ["1 %d"])
    table = np.concatenate([ids, dense, label[:, None]], 1).tolist()
    with open(path, "w") as f:
        f.write("\n".join(row % tuple(r) for r in table) + "\n")
    return np.unique(ids).size


def phase20b_server():
    """A parameter server of 20b, started as the reference's fleet PS flow
    starts one: the role from TRAINING_ROLE=PSERVER and the PADDLE_*
    variables, fleet.init(role, is_collective=False), init_server,
    run_server (until the trainer's stop_worker)."""
    from paddle_tpu_torch._testing import force_cpu
    force_cpu()
    import paddle_tpu_torch.distributed.fleet as fleet
    role = fleet.PaddleCloudRoleMaker()
    assert role.is_server()
    fleet.init(role, is_collective=False)
    fleet.init_server()
    fleet.run_server()


def start_ps_servers():
    """The two server processes; returns (their endpoints, the Popens)."""
    ports = [_free_port() for _ in range(CTR_SERVERS)]
    eps = [f"127.0.0.1:{p}" for p in ports]
    procs = []
    for p in ports:
        env = dict(os.environ, TRAINING_ROLE="PSERVER", PADDLE_PORT=str(p),
                   PADDLE_PSERVERS_IP_PORT_LIST=",".join(eps),
                   PADDLE_TRAINERS_NUM="1", CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase20b-server"],
            env=env))
    return eps, procs


def _wait_listening(eps, procs, timeout=120):
    import socket
    deadline = time.time() + timeout
    for ep in eps:
        host, port = ep.rsplit(":", 1)
        while True:
            try:
                socket.create_connection((host, int(port)), timeout=1).close()
                break
            except OSError:
                if time.time() > deadline or any(p.poll() is not None
                                                  for p in procs):
                    raise RuntimeError(f"PS server {ep} did not start")
                time.sleep(0.1)


def _ctr_mlp(paddle):
    from paddle_tpu_torch import nn
    layers = []
    for i, (a, b) in enumerate(zip(CTR_MLP[:-1], CTR_MLP[1:])):
        layers.append(nn.Linear(a, b))
        if i < len(CTR_MLP) - 2:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class _CtrTrainer:
    """The trainer of 20b: a step pulls the MLP's parameters (a dense table
    over both servers) and the batch's embedding rows (an Adam sparse
    table), runs forward and backward on the current place, and pushes
    both gradients back."""

    def __init__(self, paddle, torch, client, sparse_id, dense_id):
        self.paddle, self.torch = paddle, torch
        self.client, self.sparse_id, self.dense_id = client, sparse_id, \
            dense_id
        paddle.seed(20)
        self.mlp = _ctr_mlp(paddle)
        self.params = list(self.mlp.parameters())
        self.sizes = [int(np.prod(p.shape)) for p in self.params]
        self.n = sum(self.sizes)
        self.times = {k: [] for k in ("pull_sparse", "pull_dense",
                                      "card_step", "push_sparse",
                                      "push_dense")}
        self.cuda = paddle.get_device().startswith("gpu")

    def init_flat(self):
        return np.concatenate([p.numpy().ravel() for p in self.params])

    def step(self, batch, train=True):
        paddle, torch, c = self.paddle, self.torch, self.client
        F = paddle.nn.functional
        keys = np.concatenate([t.numpy() for t in batch[:CTR_SLOTS]], 1)
        b = keys.shape[0]
        t0 = time.perf_counter()
        rows = c.pull_sparse(self.sparse_id, keys.ravel())
        t1 = time.perf_counter()
        flat = c.pull_dense(self.dense_id, self.n)
        t2 = time.perf_counter()
        off = 0
        for p, n in zip(self.params, self.sizes):
            p.set_value(flat[off:off + n].reshape(p.shape))
            off += n
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        emb = paddle.to_tensor(rows.reshape(b, CTR_SLOTS * CTR_DIM),
                               stop_gradient=not train)
        x = paddle.concat([emb, batch[CTR_SLOTS].astype("float32")], 1)
        logit = self.mlp(x).squeeze(-1)
        loss = F.binary_cross_entropy_with_logits(
            logit, batch[CTR_SLOTS + 1].squeeze(-1).astype("float32"))
        if not train:
            return float(loss), None
        loss.backward()
        g_emb = emb.grad.numpy().reshape(-1, CTR_DIM)
        g_dense = np.concatenate([p.grad.numpy().ravel()
                                  for p in self.params])
        if self.cuda:
            ev[1].record()
            torch.cuda.synchronize()
            self.times["card_step"].append(ev[0].elapsed_time(ev[1]) / 1e3)
        for p in self.params:
            p.clear_gradient()
        t3 = time.perf_counter()
        c.push_sparse(self.sparse_id, keys.ravel(), g_emb)
        t4 = time.perf_counter()
        c.push_dense(self.dense_id, g_dense)
        t5 = time.perf_counter()
        for k, dt in (("pull_sparse", t1 - t0), ("pull_dense", t2 - t1),
                      ("push_sparse", t4 - t3), ("push_dense", t5 - t4)):
            self.times[k].append(dt)
        return float(loss), (g_emb, g_dense)


def _profile_ctr_step(torch, card, batch):
    """One training step of 20b under the port's Profiler, after a READY
    step that starts its device tracer: (the step's host ms, its kernel
    rows)."""
    from paddle_tpu_torch import profiler
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=profiler.make_scheduler(ready=1, record=1))
    prof.start()
    card.step(batch)
    prof.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.stop()
    return wall_ms, [k for k in prof._all_spans() if k.pid == 1], \
        prof.device_launches_unrecorded


def _busy_ms(spans):
    """The union of the spans' intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((k.start_us, k.end_us) for k in spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def drive_ps_ctr(run, paddle, torch, eps, procs):
    """20b: the parameter-server CTR loop at the Criteo DNN's widths: the
    data through InMemoryDataset's native parser, the two servers, then
    the CPU check (4 steps on the CPU through the plain path against a
    second pair of tables), one training pass of 32 steps on the card and
    an evaluation pass."""
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import native
    out = {"servers": CTR_SERVERS, "rows": CTR_ROWS, "batch": CTR_BATCH,
           "mlp": list(CTR_MLP), "ids": CTR_IDS, "dim": CTR_DIM}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "part-0")
        t0 = time.perf_counter()
        distinct = ctr_data(path, 20)
        out["data_gen_s"] = time.perf_counter() - t0

        class Var:
            def __init__(self, dtype):
                self.dtype = dtype
        use = [Var("int64")] * CTR_SLOTS + [Var("float32"), Var("int64")]
        ds = dist.InMemoryDataset()
        ds.set_filelist([path])
        ds.set_use_var(use)
        t0 = time.perf_counter()
        ds.load_into_memory()
        out["native_parse_ms"] = (time.perf_counter() - t0) * 1e3
        out["file_mb"] = os.path.getsize(path) / 1e6
        # the Python parser against the native one on the file's head
        head = os.path.join(d, "head")
        with open(path) as src, open(head, "w") as dst:
            dst.writelines(itertools.islice(src, CTR_PARSE_ROWS))
        is_float = [False] * CTR_SLOTS + [True, False]
        t0 = time.perf_counter()
        fast = native.parse_multislot_file(head, is_float)
        out["native_parse_head_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain = native.parse_multislot_file_py(head, is_float)
        out["python_parse_head_ms"] = (time.perf_counter() - t0) * 1e3
    same = all(np.array_equal(v, pv) and np.array_equal(o, po)
               for (v, o), (pv, po) in zip(fast, plain))
    # the whole file's first rows are the head's
    same = same and all(
        np.array_equal(o[:CTR_PARSE_ROWS + 1], po)
        and np.array_equal(v[:po[-1]], pv)
        for (v, o), (pv, po) in zip(ds.slot_arrays(), plain))
    run.check(same and ds.get_memory_data_size() == CTR_ROWS,
              f"20b: InMemoryDataset's native parse of {CTR_ROWS} rows "
              f"({out['file_mb']:.1f} MB, {out['native_parse_ms']:.1f} ms) "
              f"begins with the Python parser's {CTR_PARSE_ROWS} rows of "
              f"the file's head, which the native parser reads equal "
              f"({out['native_parse_head_ms']:.1f} ms against "
              f"{out['python_parse_head_ms']:.1f})")
    _wait_listening(eps, procs)
    role = fleet.UserDefinedRoleMaker(role=fleet.Role.WORKER, worker_num=1,
                                      server_endpoints=eps)
    fleet.init(role, is_collective=False)
    fleet.init_worker()
    client = fleet.ps_client
    try:
        for sid, did in ((CTR_SPARSE, CTR_DENSE_T),
                         (CPU_SPARSE, CPU_DENSE_T)):
            client.create_sparse_table(sid, dim=CTR_DIM, optimizer="adam",
                                       lr=CTR_LR, seed=20)
        paddle.set_device("cpu")
        cpu = _CtrTrainer(paddle, torch, client, CPU_SPARSE, CPU_DENSE_T)
        init = cpu.init_flat()
        for did in (CTR_DENSE_T, CPU_DENSE_T):
            client.create_dense_table(did, cpu.n, optimizer="adam",
                                      lr=CTR_LR)
            client.set_dense(did, init)
        want = [cpu.step(b) for _, b in zip(
            range(CTR_CHECK_STEPS), ds.batch_generator(CTR_BATCH))]
        paddle.set_device("gpu:0")
        card = _CtrTrainer(paddle, torch, client, CTR_SPARSE, CTR_DENSE_T)
        losses, got = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, b in enumerate(ds.batch_generator(CTR_BATCH)):
            loss, grads = card.step(b)
            losses.append(loss)
            if i < CTR_CHECK_STEPS:
                got.append((loss, grads))
        pass_s = time.perf_counter() - t0
        eval_losses = [card.step(b, train=False)[0]
                       for b in ds.batch_generator(CTR_BATCH)]
        wall_ms, kernels, unrecorded = _profile_ctr_step(
            torch, card, next(ds.batch_generator(CTR_BATCH)))
        size = client.sparse_size(CTR_SPARSE)
    finally:
        fleet.stop_worker()
    codes = [p.wait(timeout=60) for p in procs]
    worst = max(max(_rel(g[0], w[0]), _rel(g[1][0], w[1][0]),
                    _rel(g[1][1], w[1][1])) for g, w in zip(got, want))
    run.check(len(got) == CTR_CHECK_STEPS and worst <= CTR_TOL,
              f"20b: the first {CTR_CHECK_STEPS} steps' losses and pushed "
              f"gradients (sparse and dense) on the card equal the CPU's "
              f"plain path within {CTR_TOL} relative (worst {worst:.3e}; "
              f"card {[round(g[0], 6) for g in got]}, CPU "
              f"{[round(w[0], 6) for w in want]})")
    first, second = float(np.mean(losses)), float(np.mean(eval_losses))
    run.check(len(losses) == CTR_ROWS // CTR_BATCH and second < first
              and np.isfinite(losses).all(),
              f"20b: {len(losses)} steps; the evaluation pass's mean loss "
              f"{second:.5f} below the training pass's {first:.5f}")
    run.check(size == distinct and codes == [0] * CTR_SERVERS,
              f"20b: sparse_size {size} equals the {distinct} distinct ids "
              f"of the data; the servers stopped with {codes}")
    gemms = [k for k in kernels if re.search("gemm|gemv", k.name, re.I)]
    kernel_ms = _busy_ms(kernels)
    run.check(len(gemms) >= CTR_GEMMS and not unrecorded,
              f"20b: the profiled step's trace holds {len(kernels)} kernel "
              f"rows, {len(gemms)} of them GEMM or GEMV, at least the "
              f"MLP's {CTR_GEMMS} (forward, input and weight gradients); "
              f"its launches without a row: {unrecorded}")
    for k, ts in card.times.items():
        out[f"{k}_ms"] = _ms_median(ts[1:])
    step_ms = pass_s / len(losses) * 1e3
    out.update({
        "steps": len(losses), "loss_train_pass": first,
        "loss_eval_pass": second, "cpu_check_rel_err": worst,
        "examples_per_s": CTR_ROWS / pass_s, "pass_s": pass_s,
        "sparse_size": size, "distinct_ids": distinct,
        "idle_share": 1.0 - kernel_ms / wall_ms,
        "idle_share_events_bound": 1.0 - out["card_step_ms"] / step_ms,
        "profiled_step_ms": wall_ms, "profiled_kernel_ms": kernel_ms,
        "profiled_kernel_rows": len(kernels), "profiled_gemm_rows":
        len(gemms), "profiled_launches_without_a_row": len(unrecorded),
        "phase_s": time.perf_counter() - t_phase})
    print(f"20b: {out['examples_per_s']:.1f} examples/s ({len(losses)} steps "
          f"of B{CTR_BATCH} in {pass_s:.2f} s); medians: pull sparse "
          f"{out['pull_sparse_ms']:.2f} ms, pull dense "
          f"{out['pull_dense_ms']:.2f}, card step {out['card_step_ms']:.3f} "
          f"(CUDA events), push sparse {out['push_sparse_ms']:.2f}, push "
          f"dense {out['push_dense_ms']:.2f}; idle share of a profiled step "
          f"{out['idle_share']:.4f} ({kernel_ms:.3f} ms of kernels busy, "
          f"{len(kernels)} rows, in {wall_ms:.2f}), at least "
          f"{out['idle_share_events_bound']:.4f} from the CUDA events' card "
          f"step over the pass's mean step of {step_ms:.2f} ms; parse "
          f"native {out['native_parse_ms']:.1f} ms (its {CTR_PARSE_ROWS}-row "
          f"head {out['native_parse_head_ms']:.1f}"
          f" ms, Python {out['python_parse_head_ms']:.1f})", flush=True)
    return out


def phase20c_worker(port, out):
    """A rank of 20c's gloo job: joins the job, heartbeats its membership
    into the launcher's TCP elastic store (ElasticManager), all-reduces,
    waits to see both members, and rank 0 writes the store's keys."""
    from paddle_tpu_torch._testing import force_cpu
    force_cpu()
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.elastic import (ElasticManager,
                                                      TCPKVStore)
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    kv = TCPKVStore("127.0.0.1", int(port))
    m = ElasticManager(kv, "smoke", rank, heartbeat_s=0.2, ttl_s=10).start()
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    kv.put(f"smoke/sum/{rank}", str(float(t[0])))
    deadline = time.time() + 60
    while m.world() != list(range(world)) and time.time() < deadline:
        time.sleep(0.05)
    dist.barrier()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(kv.get_prefix(""), f)
    dist.barrier()
    m.stop()
    dist.destroy_process_group()


def start_elastic_job(d):
    """20c's job: 2 gloo ranks under the launcher with a tcp:// elastic
    store; returns (the store's port, the Popen)."""
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--np_range", "2:2", "--elastic_store",
         f"tcp://127.0.0.1:{port}", os.path.abspath(__file__),
         "--phase20c-worker", str(port), os.path.join(d, "keys.json")],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return port, proc


def finish_elastic_job(run, d, port, proc):
    try:
        _, err = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
    path = os.path.join(d, "keys.json")
    keys = json.load(open(path)) if os.path.exists(path) else {}
    sums = {k: v for k, v in keys.items() if k.startswith("smoke/sum/")}
    nodes = sorted(k for k in keys if k.startswith("elastic/smoke/nodes/"))
    run.check(proc.returncode == 0 and sorted(sums.values()) == ["3.0"] * 2
              and nodes == ["elastic/smoke/nodes/0", "elastic/smoke/nodes/1"],
              f"20c: 2 gloo ranks under launch --elastic_store "
              f"tcp://127.0.0.1:{port} ran to completion (exit "
              f"{proc.returncode}); both heartbeats and all-reduced sums "
              f"3.0 in the store: {sorted(keys)}"
              + ("" if proc.returncode == 0 else f"; {err[-600:]}"))
    print(f"20c: the elastic store's keys: {sorted(keys)}", flush=True)
    return {"store_port": port, "keys": sorted(keys), "sums": sums}


def _gpt_stages(paddle, model, split):
    """Two programs over the Layer GPT: (ids) -> the hidden state after
    block ``split - 1`` (the embedding and blocks 0..split-1); (hidden,
    labels) -> the LM loss (the other blocks, the final norm, the head)."""
    gpt = model.gpt

    def stage0(ids):
        pos = paddle.arange(ids.shape[1], dtype="int64").unsqueeze(0)
        x = gpt.drop(gpt.wte(ids) + gpt.wpe(pos))
        for blk in gpt.blocks[:split]:
            x = blk(x)
        return x

    def stage1(x, labels):
        for blk in gpt.blocks[split:]:
            x = blk(x)
        x = gpt.ln_f(x)
        logits = paddle.matmul(x, gpt.wte.weight, transpose_y=True) \
            if gpt.cfg.tie_embeddings else gpt.lm_head(x)
        return model.loss_fn(logits[:, :-1].reshape([-1, logits.shape[-1]]),
                             labels[:, 1:].reshape([-1]))
    return stage0, stage1


def drive_fleet_executor(run, paddle, GPTConfig, GPTForCausalLM, mods, fa,
                         torch):
    """20d: distributed inference of the Layer GPT at MEDIUM's widths
    (bf16, S2048) through FleetExecutor: stage 0 the embedding and blocks
    0-11 (a Source interceptor), stage 1 blocks 12-23, the final norm and
    the LM loss (Compute), a Sink that collects the losses; 4 microbatches
    of B1, against the unsplit forward. Returns (result, the model)."""
    from paddle_tpu_torch.distributed import fleet_executor as fe
    paddle.set_device("gpu:0")
    cfg = GPTConfig(**MEDIUM)
    paddle.seed(0)
    model = GPTForCausalLM(cfg)
    _gpt_normal_init(model, 20, torch)
    model.bfloat16()
    model.eval()
    L = cfg.num_layers
    ids = np.random.RandomState(20).randint(0, cfg.vocab_size,
                                            (FE_MICRO, 1, MEDIUM_SEQ))
    micro = [paddle.to_tensor(m) for m in ids]
    stage0, stage1 = _gpt_stages(paddle, model, FE_SPLIT)

    def no_grad(fn):
        # grad mode is a thread's own: the interceptors' threads set theirs
        def run_it(*args):
            with paddle.no_grad():
                return fn(*args)
        return run_it
    stage0, stage1 = no_grad(stage0), no_grad(stage1)

    def launches():
        return _launches(mods)

    def zero():
        for mod in mods:
            mod.reset_launch_counts()

    def split_run():
        losses = []
        nodes = [
            fe.TaskNode(task_id=0, max_run_times=FE_MICRO,
                        node_type="Source",
                        program=lambda s, i: (stage0(micro[s]), micro[s])),
            fe.TaskNode(task_id=1, max_run_times=FE_MICRO,
                        program=lambda s, i: stage1(*i[0])),
            fe.TaskNode(task_id=2, max_run_times=FE_MICRO, node_type="Sink",
                        program=lambda s, i: losses.append(float(i[1]))),
        ]
        for up, down in ((0, 1), (1, 2)):
            nodes[up].add_downstream_task(down, 2)
            nodes[down].add_upstream_task(up, 2)
        ex = fe.FleetExecutor()
        ex.init(0, nodes)
        try:
            ex.run(timeout=300)
        finally:
            ex.stop()
        return losses

    with paddle.no_grad():
        [float(model(m, m)) for m in micro[:1]]          # warm-up
        split_run()
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        whole = [float(model(m, m)) for m in micro]
        whole_ms = (time.perf_counter() - t0) * 1e3
        whole_launches = launches()
        zero()
        t0 = time.perf_counter()
        got = split_run()
        torch.cuda.synchronize()
        split_ms = (time.perf_counter() - t0) * 1e3
        got_launches = launches()
    rel = max(abs(a - w) / abs(w) for a, w in zip(got, whole)) \
        if len(got) == FE_MICRO else float("inf")
    want = {n: (L * FE_MICRO if n == "library_flash_fwd" else 0)
            for n in got_launches}
    run.check(len(got) == FE_MICRO and rel <= TOL["bfloat16"]
              and 10.0 <= got[0] <= 11.5,
              f"20d: FleetExecutor's {FE_MICRO} microbatch losses "
              f"{[round(x, 5) for x in got]} equal the unsplit forward's "
              f"{[round(x, 5) for x in whole]} within {TOL['bfloat16']} "
              f"relative (worst {rel:.3e}; bit-equal: {got == whole})")
    run.check(got_launches == want and whole_launches == want,
              f"20d: {L} launches of lf_fwd a microbatch and no other "
              f"attention kernel, split and unsplit: {got_launches}")
    print(f"20d: FleetExecutor {split_ms:.2f} ms for {FE_MICRO} microbatches "
          f"of B1 S{MEDIUM_SEQ} (host clock, synchronized) against "
          f"{whole_ms:.2f} unsplit", flush=True)
    return {"losses": got, "unsplit_losses": whole, "loss_rel_err": rel,
            "bit_equal": got == whole, "split_ms": split_ms,
            "unsplit_ms": whole_ms, "launches": got_launches}, model


def phase20e_worker(master):
    """20e's peer: init_rpc as "peer" (rank 1) on the card; serves calls
    until the trainer releases it."""
    from paddle_tpu_torch._testing import rpc_peer
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu:0")
    rpc_peer("peer", 1, 2, master)


def start_rpc_peer():
    """The trainer's init_rpc (rank 0) and the peer process."""
    from paddle_tpu_torch.distributed import rpc
    master = f"127.0.0.1:{_free_port()}"
    rpc.init_rpc("trainer", rank=0, world_size=2, master_endpoint=master)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--phase20e-worker", master])
    return proc


def drive_rpc(run, paddle, torch, proc):
    """20e: rpc_sync and rpc_async round trips to the peer process, a small
    call and a 4 MB array, and a callee that runs a matmul on the card."""
    import operator
    from paddle_tpu_torch._testing import rpc_matmul, rpc_release
    from paddle_tpu_torch.distributed import rpc
    deadline = time.time() + 120
    while len(rpc.get_all_worker_infos()) < 2:
        if time.time() > deadline or proc.poll() is not None:
            run.check(False, "20e: the rpc peer registered")
            return {}
        time.sleep(0.05)
    out = {}
    big = np.random.RandomState(20).randn(RPC_BIG_BYTES // 8)

    def sync_us(fn, args, n):
        t0 = time.perf_counter()
        for _ in range(n):
            r = rpc.rpc_sync("peer", fn, args=args)
        return (time.perf_counter() - t0) / n * 1e6, r

    def async_us(fn, args, n):
        t0 = time.perf_counter()
        futs = [rpc.rpc_async("peer", fn, args=args) for _ in range(n)]
        r = [f.wait() for f in futs][-1]
        return (time.perf_counter() - t0) / n * 1e6, r
    sync_us(operator.add, (1, 2), 10)
    out["sync_small_us"], small = sync_us(operator.add, (1, 2), RPC_CALLS)
    out["async_small_us"], small_a = async_us(operator.add, (1, 2),
                                              RPC_CALLS)
    n_big = max(RPC_CALLS // 10, 5)
    out["sync_4mb_us"], echo = sync_us(np.negative, (big,), n_big)
    out["async_4mb_us"], echo_a = async_us(np.negative, (big,), n_big)
    run.check(small == small_a == 3 and np.array_equal(echo, -big)
              and np.array_equal(echo_a, -big),
              f"20e: rpc_sync and rpc_async return the callee's values (a "
              f"small call and a {RPC_BIG_BYTES >> 20} MB array)")
    rs = np.random.RandomState(21)
    a = rs.randn(1024, 1024).astype(np.float32)
    b = rs.randn(1024, 1024).astype(np.float32)
    remote = rpc.rpc_sync("peer", rpc_matmul, args=(a, b))
    local = rpc_matmul(a, b)
    rel = _rel(remote, local)
    run.check(rel <= 1e-5,
              f"20e: a callee's card matmul (1024^2, f32) equals the local "
              f"call within 1e-5 relative (worst {rel:.3e}, bit-equal "
              f"{np.array_equal(remote, local)})")
    rpc.rpc_sync("peer", rpc_release)
    code = proc.wait(timeout=60)
    rpc.shutdown()
    run.check(code == 0, f"20e: the rpc peer exited with {code}")
    out["matmul_rel_err"] = rel
    print(f"20e: rpc round trips (us): sync {out['sync_small_us']:.1f}, "
          f"async {out['async_small_us']:.1f} (small); sync "
          f"{out['sync_4mb_us']:.1f}, async {out['async_4mb_us']:.1f} "
          f"({RPC_BIG_BYTES >> 20} MB each way)", flush=True)
    return out


LF_KERNELS = {"mma_online_fwd_kernel": "library_flash_fwd",
              "mma_dq_kernel": "library_flash_bwd_dq",
              "mma_dkv_kernel": "library_flash_bwd_dkv"}


def drive_profiler(run, paddle, fa, torch, model):
    """20f: Profiler(targets=[CPU, GPU], scheduler=make_scheduler(closed=1,
    ready=1, record=2, repeat=2)) over 8 training steps of 20d's Layer GPT
    (B4 S2048, AdamW(1e-4, multi_precision)): the chrome trace's
    RecordEvent, op:: and kernel rows; a Profiler without a scheduler over
    2 steps; the step's ms with the profiler on and off."""
    from paddle_tpu_torch import profiler
    model.train()
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    loss_fn = _lm_loss(paddle)
    ids = paddle.to_tensor(np.random.RandomState(20).randint(
        0, MEDIUM["vocab_size"], (MEDIUM_BATCH, MEDIUM_SEQ)))
    L = MEDIUM["num_layers"]

    def step():
        with profiler.RecordEvent("train_step"):
            loss = loss_fn(model(ids), ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return float(loss)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        return loss, (time.perf_counter() - t0) * 1e3
    off = [timed() for _ in range(PROF_STEPS)]
    targets = [profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU]
    prof = profiler.Profiler(targets=targets,
                             scheduler=profiler.make_scheduler(
                                 closed=1, ready=1, record=2,
                                 repeat=PROF_WINDOWS))
    prof.start()
    on, states = [], []
    for _ in range(PROF_STEPS * PROF_WINDOWS):
        states.append(prof.current_state.name)
        on.append(timed())
        prof.step(num_samples=MEDIUM_BATCH)
    prof.stop()
    # no scheduler: the device tracer starts with the first recorded step
    plain = profiler.Profiler(targets=targets)
    plain.start()
    for _ in range(PROF_PLAIN_STEPS):
        timed()
        plain.step()
    plain.stop()
    plain_counts = {lib: sum(1 for e in plain._all_spans()
                             if e.pid == 1 and k in e.name)
                    for k, lib in LF_KERNELS.items()}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export(path)
        events = profiler.load_profiler_result(path)["traceEvents"]
        trace_mb = os.path.getsize(path) / 1e6
    recorded = [i for i, s in enumerate(states) if s.startswith("RECORD")]
    spans = [e for e in events if e.get("ph") == "X"]
    steps = sum(1 for e in spans if e["name"] == "train_step")
    ops = sum(1 for e in spans if e["name"].startswith("op::"))
    kernels = [e for e in spans if e.get("cat") == "kernel"]
    counts = {lib: sum(1 for e in kernels if k in e["name"])
              for k, lib in LF_KERNELS.items()}
    want = {lib: L * len(recorded) for lib in LF_KERNELS.values()}
    table = prof.summary()
    run.check(states == ["CLOSED", "READY", "RECORD", "RECORD_AND_RETURN"]
              * PROF_WINDOWS and steps == len(recorded) and ops > 0
              and counts == want and not prof.device_launches_unrecorded,
              f"20f: the exported trace of {PROF_WINDOWS} windows holds "
              f"{steps} RecordEvent spans of the recorded steps {recorded}, "
              f"{ops} op:: spans and {len(kernels)} kernel rows, the library "
              f"kernels {counts} ({L} a recorded step each); launches "
              f"without a row: {prof.device_launches_unrecorded[:8]}")
    # without a READY step: every launch of the recording has its row (the
    # kernels link torch's shared CUDA runtime; their first launches of a
    # window lost their rows late in a long process while each library
    # carried a static runtime of its own)
    want_plain = {lib: L * PROF_PLAIN_STEPS for lib in LF_KERNELS.values()}
    short = {lib: want_plain[lib] - n for lib, n in plain_counts.items()
             if n != want_plain[lib]}
    lost = plain.device_launches_unrecorded
    print(f"20f: without a scheduler, library kernel rows {plain_counts}; "
          f"launches without a row (call, correlation id, us after the "
          f"recording's marker, the op that made it): {lost[:16]}; "
          f"kernels short: {short}",
          flush=True)
    run.check(plain_counts == want_plain and not lost,
              f"20f: a profiler without a scheduler over {PROF_PLAIN_STEPS} "
              f"steps holds the library kernels {plain_counts} ({L} a step "
              f"each) and no launch without a row ({len(lost)}: "
              f"{lost[:8]})")
    on_ms = float(np.median([t for i, (_, t) in enumerate(on)
                             if i in recorded]))
    off_ms = float(np.median([t for _, t in off[1:]]))
    print(f"20f: a training step {off_ms:.2f} ms with the profiler off "
          f"(median of steps 2-{PROF_STEPS}), {on_ms:.2f} ms recorded "
          f"(steps {recorded}); trace {trace_mb:.1f} MB", flush=True)
    del opt
    return {"states": states, "recorded_steps": recorded,
            "record_event_spans": steps, "op_spans": ops,
            "kernel_rows": len(kernels), "library_kernel_rows": counts,
            "library_kernel_rows_no_scheduler": plain_counts,
            "launches_without_a_row": [
                len(prof.device_launches_unrecorded), len(lost)],
            "library_rows_short_no_scheduler": short,
            "launches_without_a_row_no_scheduler": lost[:16],
            "step_ms_off": off_ms, "step_ms_recorded": on_ms,
            "losses": [x for x, _ in off + on], "trace_mb": trace_mb,
            "summary_top": table.splitlines()[:6]}


def drive_phase20(run, paddle, GPTConfig, GPTForCausalLM, mods, fa, torch):
    """Phase 20, the host runtime: 20a alone (its timings on a quiet
    host); then the PS servers, the rpc peer and 20c's gloo job start, and
    come up while 20b writes and parses its data; then 20b-20f."""
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    out["native"] = drive_native(run, paddle, torch)
    print(f"20a: {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as d:
        eps, servers = start_ps_servers()
        peer = start_rpc_peer()
        port, job = start_elastic_job(d)
        try:
            t0 = time.perf_counter()
            out["ps_ctr"] = drive_ps_ctr(run, paddle, torch, eps, servers)
            print(f"20b: {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            out["elastic_tcp"] = finish_elastic_job(run, d, port, job)
            print(f"20c: {time.perf_counter() - t0:.1f} s after 20b",
                  flush=True)
        finally:
            for p in servers + [job]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    try:
        t0 = time.perf_counter()
        out["fleet_executor"], model = drive_fleet_executor(
            run, paddle, GPTConfig, GPTForCausalLM, mods, fa, torch)
        print(f"20d: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        out["rpc"] = drive_rpc(run, paddle, torch, peer)
        print(f"20e: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        if peer.poll() is None:
            peer.kill()
            peer.wait()
    t0 = time.perf_counter()
    out["profiler"] = drive_profiler(run, paddle, fa, torch, model)
    print(f"20f: {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_20_s"] = time.perf_counter() - t_phase
    print(f"host runtime phase: {out['phase_20_s']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------- phase 21
# The breadth slice's modules at the widths their users run.
# 21a: Faster R-CNN R50-C4's detection head at COCO test size (Ren et al.
# 2015; Detectron's e2e_faster_rcnn_R-50-C4_1x: an 800 x 1333 image, the
# C4 map at stride 16, 15 anchors a position (sizes 32-512, ratios 0.5, 1,
# 2), RPN pre-NMS top 6000, post-NMS 1000 at IoU 0.7, RoIAlign 14 x 14 at
# 1/16, 81 classes, box weights (10, 10, 5, 5), test NMS 0.5 after a 0.05
# score threshold, 100 detections; FPN levels 2-5 at 224 / level 4).
DET_IMAGE = (800, 1333)
DET_MAP = (1024, 50, 84)
DET_SIZES, DET_RATIOS = (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)
DET_PRE, DET_POST, DET_RPN_NMS = 6000, 1000, 0.7
DET_POOL, DET_CLASSES, DET_NMS, DET_SCORE, DET_KEEP = 14, 81, 0.5, 0.05, 100
# the CPU's plain roi_align on this many of the RoIs (each RoI's output is
# a function of its box and the map alone; the card computes all of them)
DET_CPU_ROIS = 128
DET_ROI_PEAK_GB = 8.0
# 21b: DCNv2 (Zhu et al. 2019): modulated deformable 3x3 convolutions in
# ResNet-50's conv3-conv5 at B2 on 800 x 1333 inputs.
DCN_BATCH = 2
DCN_STAGES = (("conv3", 128, 100, 167), ("conv4", 256, 50, 84),
              ("conv5", 512, 25, 42))
# 21c: Llama-2-7B's prefill from the fused functions, bf16, B1 S2048; the
# ragged check's lengths
FUSED_BATCH, FUSED_SEQ = 1, 2048
RAGGED_LENS = (512, 1024, 1536, 2048)
# 21d: one fused_moe layer at Mixtral-8x7B's widths (Jiang et al. 2024)
MOE_WIDTHS = dict(hidden=4096, experts=8, inner=14336, top_k=2)
MOE_BATCH, MOE_SEQ = 1, 1024
# 21e: Whisper's log-mel front end (Radford et al. 2022): 16 kHz, n_fft
# 400, hop 160, 80 mel bins (f_min 0, f_max 8000), 30 s clips
MEL = dict(sr=16000, n_fft=400, hop_length=160, n_mels=80, f_min=0.0,
           top_db=80.0)
MEL_BATCH, MEL_SAMPLES, MEL_MFCC = 32, 480000, 40
# 21f: the Layer GPT at MEDIUM's widths, 2:4-pruned, LookAhead(AdamW)
SPARSE_STEPS, SPARSE_K, SPARSE_LR = 6, 5, 1e-3


def _event_ms(torch, fn, reps=5):
    """The median over ``reps`` calls of fn's CUDA-event ms (each call
    alone, synchronized after), after one warm-up call; and fn's last
    value."""
    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = None                    # the last call's value, freed first
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), out


def _rel_err(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def detection_inputs(seed):
    """The C4 map, the RPN's scores and deltas, its anchors [H, W, A, 4]
    (A = 15) and unit variances, the image size, the second stage's class
    logits and box deltas, all from ``seed``."""
    rs = np.random.RandomState(seed)
    c, h, w = DET_MAP
    stride = 16
    base = []
    for size in DET_SIZES:
        for ratio in DET_RATIOS:
            bw, bh = size / np.sqrt(ratio), size * np.sqrt(ratio)
            base.append((-bw / 2, -bh / 2, bw / 2, bh / 2))
    base = np.asarray(base, np.float32)                    # [15, 4]
    ys, xs = np.meshgrid((np.arange(h) + 0.5) * stride,
                         (np.arange(w) + 0.5) * stride, indexing="ij")
    shift = np.stack([xs, ys, xs, ys], -1).astype(np.float32)
    anchors = shift[:, :, None, :] + base[None, None]      # [H, W, 15, 4]
    a = len(base)
    return {
        "feat": rs.randn(1, c, h, w).astype(np.float32),
        "scores": rs.rand(1, a, h, w).astype(np.float32),
        "deltas": (rs.randn(1, 4 * a, h, w) * 0.3).astype(np.float32),
        "anchors": anchors.astype(np.float32),
        "variances": np.ones_like(anchors),
        "im_info": np.asarray([DET_IMAGE], np.float32),
        "cls_logits": (rs.randn(DET_POST, DET_CLASSES) * 2.5).astype(
            np.float32),
        "box_deltas": (rs.randn(DET_POST, DET_CLASSES, 4) * 0.5).astype(
            np.float32),
    }


def detection_head(paddle, arrays, device, timings=None):
    """The R50-C4 head's ops on ``device``: generate_proposals,
    roi_align of the RoIs to 14 x 14, box_coder's decode of their class
    boxes, the class-aware nms, distribute_fpn_proposals. Returns each
    op's output as numpy (roi_align's on the first DET_CPU_ROIS RoIs where
    ``device`` is the CPU). With ``timings`` (a dict), the card's ms of
    each op (median of 5) are written there."""
    import torch
    V = paddle.vision.ops
    paddle.set_device(device)
    t = {k: paddle.to_tensor(v) for k, v in arrays.items()}

    def timed(name, fn):
        if timings is None:
            return fn()
        ms, out = _event_ms(torch, fn)
        timings[name] = ms
        return out

    rois, _, nums = timed("generate_proposals_ms", lambda: V.generate_proposals(
        t["scores"], t["deltas"], t["im_info"], t["anchors"],
        t["variances"], pre_nms_top_n=DET_PRE, post_nms_top_n=DET_POST,
        nms_thresh=DET_RPN_NMS, min_size=0.0, return_rois_num=True))
    n_rois = int(nums.numpy()[0])
    out = {"rois": rois.numpy(), "rois_num": nums.numpy()}
    pool_rois = rois if device != "cpu" else rois[:DET_CPU_ROIS]
    pool_num = paddle.to_tensor([pool_rois.shape[0]])

    def pool():
        with paddle.no_grad():
            return V.roi_align(t["feat"], pool_rois, pool_num, DET_POOL,
                               1.0 / 16, -1, True)
    if device != "cpu":
        # the peak above what is held, over one call alone
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out["pooled"] = pool().numpy()[:DET_CPU_ROIS]
        torch.cuda.synchronize()
        out["roi_align_peak_gb"] = (torch.cuda.max_memory_allocated()
                                    - held) / 1e9
        timed("roi_align_ms", pool)
    else:
        out["pooled"] = pool().numpy()
    # each RoI's class boxes (pixel boxes, Detectron's box weights)
    decoded = timed("box_coder_ms", lambda: V.box_coder(
        rois, [0.1, 0.1, 0.2, 0.2], t["box_deltas"][:n_rois],
        "decode_center_size", box_normalized=False, axis=1))
    out["decoded"] = decoded.numpy()
    probs = paddle.nn.functional.softmax(t["cls_logits"][:n_rois], -1)
    scores = probs[:, 1:].reshape([-1])
    boxes = decoded[:, 1:].reshape([-1, 4])
    cats = paddle.to_tensor(np.tile(np.arange(1, DET_CLASSES),
                                    n_rois).astype(np.int64))
    keep = paddle.nonzero(scores > DET_SCORE).reshape([-1])
    cand = (paddle.gather(boxes, keep), paddle.gather(scores, keep),
            paddle.gather(cats, keep))
    out["nms_candidates"] = int(keep.shape[0])
    kept = timed("nms_ms", lambda: V.nms(
        cand[0], DET_NMS, cand[1], category_idxs=cand[2],
        categories=list(range(1, DET_CLASSES)), top_k=DET_KEEP))
    out["kept"] = kept.numpy()
    levels = timed("distribute_fpn_proposals_ms",
                   lambda: V.distribute_fpn_proposals(
                       rois, 2, 5, 4, 224, rois_num=nums))
    out["fpn_levels"] = [lv.numpy() for lv in levels[0]]
    out["fpn_restore"] = levels[1].numpy()
    return out


def drive_detection(run, paddle, torch):
    """21a: the detection head on the card against the CPU's plain path on
    the same inputs: index sets (proposals, their counts, nms's kept
    indices, the FPN levels) identical, floats within 1e-5 of their
    largest value; roi_align's peak memory; each op's ms, and nms's at
    6000 boxes."""
    arrays = detection_inputs(21)
    timings = {}
    t0 = time.perf_counter()
    card = detection_head(paddle, arrays, "gpu:0", timings)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = detection_head(paddle, arrays, "cpu")
    t_cpu = time.perf_counter() - t0
    paddle.set_device("gpu:0")
    same = {k: bool(np.array_equal(card[k], cpu[k]))
            for k in ("rois", "rois_num", "kept", "fpn_restore")}
    same["fpn_levels"] = all(np.array_equal(a, b) for a, b in
                             zip(card["fpn_levels"], cpu["fpn_levels"]))
    errs = {k: float(np.abs(card[k] - cpu[k]).max()
                     / max(np.abs(cpu[k]).max(), 1e-30))
            for k in ("pooled", "decoded")}
    n_rois = int(card["rois_num"][0])
    run.check(all(same.values()) and n_rois == DET_POST,
              f"21a: generate_proposals (top {DET_PRE} -> NMS "
              f"{DET_RPN_NMS} -> {DET_POST}), the class-aware nms and "
              f"distribute_fpn_proposals give the CPU's index sets on the "
              f"card ({same}, {n_rois} RoIs)")
    run.check(all(e <= 1e-5 for e in errs.values()),
              f"21a: roi_align ({DET_POST} RoIs to {DET_POOL}x{DET_POOL}, "
              f"the CPU on the first {DET_CPU_ROIS}) and box_coder's "
              f"decode ({DET_POST} x {DET_CLASSES}) within 1e-5 of the "
              f"CPU's largest value (f32): {errs}")
    run.check(card["roi_align_peak_gb"] < DET_ROI_PEAK_GB,
              f"21a: roi_align's peak {card['roi_align_peak_gb']:.2f} GB "
              f"above what the phase holds, under {DET_ROI_PEAK_GB} GB "
              "(its samples before the 2 x 2 mean are 3.2 GB in f32; a "
              "copy of the map a box would be 17 GB)")
    run.check(0 < card["nms_candidates"] and 0 < len(card["kept"])
              <= DET_KEEP, f"21a: {card['nms_candidates']} class boxes "
              f"over {DET_SCORE}, nms kept {len(card['kept'])}")
    # nms alone at 6000 boxes: the RPN's top 6000 decoded proposals
    V = paddle.vision.ops
    s = arrays["scores"][0].transpose(1, 2, 0).reshape(-1)
    order = np.argsort(-s)[:DET_PRE]
    anc = arrays["anchors"].reshape(-1, 4)[order]
    boxes6k = paddle.to_tensor(anc)
    scores6k = paddle.to_tensor(s[order])
    nms6k_ms, kept6k = _event_ms(torch, lambda: V.nms(boxes6k, DET_RPN_NMS,
                                                      scores6k))
    print(f"21a: ms (CUDA events, median of 5): {timings}; nms at "
          f"{DET_PRE} boxes {nms6k_ms:.3f} ms ({kept6k.shape[0]} kept); "
          f"roi_align peak {card['roi_align_peak_gb']:.2f} GB; the head "
          f"on the card {t_card:.1f} s with its timings, on the CPU "
          f"{t_cpu:.1f} s", flush=True)
    return {"ms": timings, "nms_6000_ms": nms6k_ms,
            "nms_6000_kept": int(kept6k.shape[0]), "rois": n_rois,
            "nms_candidates": card["nms_candidates"],
            "kept": int(len(card["kept"])),
            "fpn_level_sizes": [int(len(x)) for x in card["fpn_levels"]],
            "roi_align_peak_gb": card["roi_align_peak_gb"],
            "rel_err": errs, "index_sets_equal": same}


def _dcn_case(rs, c, h, w):
    """DCNv2 inputs of one stage: x, offsets (18), masks (9, in (0, 1)),
    the 3x3 weight (He's N(0, 2 / fan_in)) and bias."""
    return [rs.randn(DCN_BATCH, c, h, w).astype(np.float32),
            (rs.randn(DCN_BATCH, 18, h, w) * 2.0).astype(np.float32),
            (1.0 / (1.0 + np.exp(-rs.randn(DCN_BATCH, 9, h, w)))).astype(
                np.float32),
            (rs.randn(c, c, 3, 3) * np.sqrt(2.0 / (9 * c))).astype(
                np.float32),
            (rs.randn(c) * 0.1).astype(np.float32)]


def _dcn_forward_backward(paddle, arrays, device, cot):
    """Forward and backward on ``device``: (output, [dx, doffset, dmask,
    dweight, dbias]) as torch tensors."""
    paddle.set_device(device)
    x, off, mask, w, b = (paddle.to_tensor(a, stop_gradient=False)
                          for a in arrays)
    out = paddle.vision.ops.deform_conv2d(x, off, w, b, padding=1, mask=mask)
    (out * paddle.to_tensor(cot)).sum().backward()
    return out._data.detach(), [t.grad._data for t in (x, off, mask, w, b)]


def drive_dcn(run, paddle, torch):
    """21b: DCNv2's deformable convolutions at ResNet-50's conv3-conv5
    widths, B2 at 800 x 1333: forward and every gradient on the card
    against the CPU's plain path within 1e-4 of each one's largest value
    (f32); static.nn.deform_conv2d equal to vision.ops'; each stage's
    forward and forward+backward ms."""
    rs = np.random.RandomState(22)
    out, worst = {}, 0.0
    for name, c, h, w in DCN_STAGES:
        arrays = _dcn_case(rs, c, h, w)
        cot = rs.randn(DCN_BATCH, c, h, w).astype(np.float32)
        got, ggrads = _dcn_forward_backward(paddle, arrays, "gpu:0", cot)
        want, wgrads = _dcn_forward_backward(paddle, arrays, "cpu", cot)
        paddle.set_device("gpu:0")
        errs = [_rel_err(got, want)] + [_rel_err(g, v)
                                        for g, v in zip(ggrads, wgrads)]
        worst = max(worst, max(errs))
        run.check(max(errs) <= 1e-4,
                  f"21b: {name} ({c}->{c}, {h}x{w}, B{DCN_BATCH}) forward "
                  f"and its x, offset, mask, weight and bias gradients on "
                  f"the card within 1e-4 of the CPU's largest value: "
                  f"{[f'{e:.2e}' for e in errs]}")
        x, off, mask, wt, bias = (paddle.to_tensor(a) for a in arrays)
        leaves = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
        V = paddle.vision.ops

        def fwd():
            with paddle.no_grad():
                return V.deform_conv2d(x, off, wt, bias, padding=1,
                                       mask=mask)

        def fwd_bwd():
            lx, lo, lm, lw, lb = leaves
            V.deform_conv2d(lx, lo, lw, lb, padding=1,
                            mask=lm).sum().backward()
        fwd_ms, y = _event_ms(torch, fwd)
        fb_ms, _ = _event_ms(torch, fwd_bwd)
        attr = paddle.ParamAttr(
            initializer=paddle.nn.initializer.Assign(arrays[3]))
        battr = paddle.ParamAttr(
            initializer=paddle.nn.initializer.Assign(arrays[4]))
        with paddle.no_grad():
            ys = paddle.static.nn.deform_conv2d(x, off, mask, c, 3,
                                                padding=1, param_attr=attr,
                                                bias_attr=battr)
        # its own weight (a copy of the same values) may take another GEMM
        # algorithm: f32 sums of 9 c products in another order
        static_err = _rel_err(ys._data, y._data)
        run.check(static_err <= 1e-5, f"21b: {name}: static.nn."
                  f"deform_conv2d gives vision.ops.deform_conv2d's output "
                  f"within 1e-5 of its largest value ({static_err:.2e})")
        out[name] = {"fwd_ms": fwd_ms, "fwd_bwd_ms": fb_ms,
                     "rel_err": errs, "static_rel_err": static_err}
        print(f"21b: {name} {c}->{c} at {h}x{w} B{DCN_BATCH}: forward "
              f"{fwd_ms:.3f} ms, forward+backward {fb_ms:.3f} ms (CUDA "
              f"events, median of 5); worst error {max(errs):.2e}",
              flush=True)
        del leaves, got, ggrads, y, ys
    out["worst_rel_err"] = worst
    return out


def fused_llama_logits(paddle, model, ids):
    """Llama's forward written in incubate's fused functions, on the
    model's own weights: fused_rms_norm -> fused_linear q/k/v ->
    fused_rotary_position_embedding -> the variable-length attention
    without lengths ([B, S, H, D], causal) -> fused_linear o -> residual
    -> fused_rms_norm -> fused_linear gate, up -> swiglu -> fused_linear
    down -> residual; then the norm and the head."""
    IF = paddle.incubate.nn.functional
    cfg = model.llama.cfg
    eps, nh = cfg.rms_eps, cfg.num_heads
    with paddle.no_grad():
        x = model.llama.embed_tokens(ids)
        b, s, h = x.shape
        d = h // nh
        for blk in model.llama.layers:
            att, mlp = blk.self_attn, blk.mlp
            n = IF.fused_rms_norm(x, blk.input_layernorm.weight,
                                  epsilon=eps)[0]
            q = IF.fused_linear(n, att.q_proj.weight).reshape([b, s, nh, d])
            k = IF.fused_linear(n, att.k_proj.weight).reshape([b, s, nh, d])
            v = IF.fused_linear(n, att.v_proj.weight).reshape([b, s, nh, d])
            q, k, _ = IF.fused_rotary_position_embedding(
                q, k, theta=cfg.rope_theta)
            a = IF.variable_length_memory_efficient_attention(q, k, v,
                                                              causal=True)
            x = x + IF.fused_linear(a.reshape([b, s, h]), att.o_proj.weight)
            n = IF.fused_rms_norm(x, blk.post_attention_layernorm.weight,
                                  epsilon=eps)[0]
            m = IF.swiglu(IF.fused_linear(n, mlp.gate_proj.weight),
                          IF.fused_linear(n, mlp.up_proj.weight))
            x = x + IF.fused_linear(m, mlp.down_proj.weight)
        x = IF.fused_rms_norm(x, model.llama.norm.weight, epsilon=eps)[0]
        return IF.fused_linear(x, model.llama.lm_head.weight)


def llama_forward_flops_per_token(cfg, seq):
    """Forward FLOPs a token: 2 per parameter of every product (the
    layers and the head; not the embedding's lookup) and the causal
    attention's 2 x 2 x L x (S / 2) x h."""
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    kv = cfg.num_kv_heads * h // cfg.num_heads
    per_layer = h * h * 2 + h * kv * 2 + 3 * h * m
    return 2 * (L * per_layer + h * cfg.vocab_size) + 2 * L * seq * h


def drive_fused_llama(run, paddle, fa, mods, torch):
    """21c: Llama-2-7B's prefill built from incubate's fused functions
    on LlamaForCausalLM's own weights (random, seed 0, bf16) at B1 S2048:
    its logits against the model's forward, 32 lf_fwd launches a forward
    and no other attention kernel; the ragged batch through the branch
    with lengths against each sequence alone; ms, tokens/s, MFU."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    IF = paddle.incubate.nn.functional
    cfg = LlamaConfig.llama2_7b()
    L = cfg.num_layers
    paddle.set_device("gpu:0")
    t0 = time.perf_counter()
    paddle.seed(0)
    model = LlamaForCausalLM(cfg)
    model.bfloat16()
    model.eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = paddle.to_tensor(np.random.RandomState(23).randint(
        0, cfg.vocab_size, (FUSED_BATCH, FUSED_SEQ)))
    with paddle.no_grad():
        want = model(ids)._data
    _reset(mods)
    ticks0 = fa.dispatch_counts()
    got = fused_llama_logits(paddle, model, ids)._data
    torch.cuda.synchronize()
    launches = _launches(mods)
    dispatch = fa.dispatch_counts(ticks0)
    err = _rel_err(got, want)
    finite = bool(torch.isfinite(got).all())
    del got, want
    want_launches = {n: (L if n == "library_flash_fwd" else 0)
                     for n in launches}
    run.check(launches == want_launches and dispatch == {
        ("nn.sdpa", "library_flash"): L},
        f"21c: a forward of the fused-function Llama-2-7B launches lf_fwd "
        f"{L} times and no other attention kernel (launches "
        f"{ {k: v for k, v in launches.items() if v} }, dispatch "
        f"{dispatch})")
    run.check(finite and err <= 2e-2,
              f"21c: its logits (B{FUSED_BATCH} S{FUSED_SEQ}, bf16) equal "
              f"LlamaForCausalLM's forward within 2e-2 of the largest "
              f"value ({err:.3e}), finite {finite}")
    fused_ms, _ = _event_ms(torch, lambda: fused_llama_logits(
        paddle, model, ids), reps=3)

    def model_fwd():
        with paddle.no_grad():
            return model(ids)
    model_ms, _ = _event_ms(torch, model_fwd, reps=3)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tokens = FUSED_BATCH * FUSED_SEQ
    flops = llama_forward_flops_per_token(cfg, FUSED_SEQ)
    tps = tokens / (fused_ms / 1e3)
    mfu = tps * flops / PEAK_BF16_FLOPS
    # the ragged batch: 4 sequences padded to 2048, [B, H, S, D] with
    # lengths, against each alone
    gen = torch.Generator(device="cuda").manual_seed(24)
    nb, nh, d = len(RAGGED_LENS), cfg.num_heads, \
        cfg.hidden_size // cfg.num_heads
    q, k, v = (torch.randn(nb, nh, FUSED_SEQ, d, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lens = paddle.to_tensor(np.asarray(RAGGED_LENS, np.int32))
    with paddle.no_grad():
        batch = IF.variable_length_memory_efficient_attention(
            paddle.Tensor(q), paddle.Tensor(k), paddle.Tensor(v), lens,
            causal=True)._data
        errs, pad_zero = [], True
        for i, n in enumerate(RAGGED_LENS):
            alone = IF.variable_length_memory_efficient_attention(
                paddle.Tensor(q[i:i + 1, :, :n].contiguous()),
                paddle.Tensor(k[i:i + 1, :, :n].contiguous()),
                paddle.Tensor(v[i:i + 1, :, :n].contiguous()),
                paddle.to_tensor(np.asarray([n], np.int32)),
                causal=True)._data
            errs.append(_rel_err(batch[i:i + 1, :, :n], alone))
            pad_zero = pad_zero and not bool(batch[i, :, n:].any())
    del q, k, v, batch
    run.check(max(errs) <= 2e-2 and pad_zero,
              f"21c: the ragged batch (lengths {list(RAGGED_LENS)}, padded "
              f"to {FUSED_SEQ}, [B, H, S, D] with seq_lens, causal) equals "
              f"each sequence alone within 2e-2 ({[f'{e:.2e}' for e in errs]})"
              f", padded query rows exactly 0: {pad_zero}")
    print(f"21c: Llama-2-7B from the fused functions, B{FUSED_BATCH} "
          f"S{FUSED_SEQ} bf16: {fused_ms:.2f} ms a forward (CUDA events, "
          f"median of 3; LlamaForCausalLM's own {model_ms:.2f}), "
          f"{tps:.1f} tokens/s, MFU {mfu:.4f} at {flops:.4e} FLOP/token; "
          f"built in {build_s:.1f} s", flush=True)
    return {"ms": fused_ms, "model_forward_ms": model_ms,
            "tokens_per_s": tps, "mfu": mfu, "flops_per_token": flops,
            "logits_rel_err": err, "ragged_rel_err": errs,
            "lf_fwd_launches": launches["library_flash_fwd"],
            "build_s": build_s}


def moe_gathered(torch, x, gw, w1, b1, w2, b2, top_k):
    """fused_moe's function in its top-k gathered form, in f32: each token
    through its k experts only, combined with the normalised top-k
    probabilities."""
    tokens = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(tokens @ gw, -1)
    topv, topi = torch.topk(probs, top_k, -1)
    topv = topv / topv.sum(-1, keepdim=True)
    out = torch.zeros_like(tokens)
    for e in range(gw.shape[-1]):
        rows, slot = torch.nonzero(topi == e, as_tuple=True)
        if rows.numel():
            hid = torch.nn.functional.gelu(tokens[rows] @ w1[e] + b1[e],
                                           approximate="tanh")
            out.index_add_(0, rows, (hid @ w2[e] + b2[e])
                           * topv[rows, slot][:, None])
    return out.reshape(x.shape)


def drive_fused_moe(run, paddle, torch):
    """21d: one fused_moe layer at Mixtral-8x7B's widths (h4096, 8 experts
    of 14336, top-2) with the reference's GELU-with-bias FFNs, bf16 at
    B1 S1024, against the top-2 gathered form in f32 on the card."""
    IF = paddle.incubate.nn.functional
    h, e, m, k = (MOE_WIDTHS[n] for n in ("hidden", "experts", "inner",
                                          "top_k"))
    gen = torch.Generator(device="cuda").manual_seed(25)

    def draw(*shape, std=0.02):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(torch.bfloat16)
    x = draw(MOE_BATCH, MOE_SEQ, h, std=1.0)
    params = [draw(h, e), draw(e, h, m), draw(e, m), draw(e, m, h),
              draw(e, h)]
    args = [paddle.Tensor(t) for t in [x] + params]
    with paddle.no_grad():
        ms, out = _event_ms(torch, lambda: IF.fused_moe(*args, top_k=k))
    ref = moe_gathered(torch, x.float(), *(p.float() for p in params), k)
    err = _rel_err(out._data, ref)
    del ref, out, args, params
    torch.cuda.empty_cache()
    tokens = MOE_BATCH * MOE_SEQ
    dense = 4 * e * h * m + 2 * h * e + 4 * e * h     # FFNs, gate, einsums
    topk = 4 * k * h * m + 2 * h * e
    run.check(err <= 2e-2,
              f"21d: fused_moe at Mixtral-8x7B's widths (h{h}, {e} experts "
              f"of {m}, top-{k}, bf16, B{MOE_BATCH} S{MOE_SEQ}) within 2e-2 "
              f"of the top-{k} gathered form in f32 ({err:.3e})")
    print(f"21d: fused_moe {ms:.3f} ms (CUDA events, median of 5); the "
          f"dense dispatch issues {dense:.4e} FLOP/token "
          f"({tokens * dense / ms / 1e9:.1f} TFLOP/s), the top-{k} count "
          f"{topk:.4e}", flush=True)
    return {"ms": ms, "rel_err": err, "dense_flops_per_token": dense,
            "topk_flops_per_token": topk,
            "dense_tflops": tokens * dense / ms / 1e9}


def drive_logmel(run, paddle, torch):
    """21e: Whisper's log-mel front end (LogMelSpectrogram, and MFCC of 40
    coefficients) at B32 x 30 s on the card against the CPU's plain path
    within 1e-4 of the largest value; paddle.fft's rfft/irfft round trip
    of a clip; ms a batch and clips/s."""
    A = paddle.audio.features
    rs = np.random.RandomState(26)
    clips = (rs.randn(MEL_BATCH, MEL_SAMPLES) * 0.1).astype(np.float32)
    out = {}
    errs = {}
    for name, make in (("log_mel", lambda: A.LogMelSpectrogram(**MEL)),
                       ("mfcc", lambda: A.MFCC(n_mfcc=MEL_MFCC, **MEL))):
        paddle.set_device("cpu")
        want = make()(paddle.to_tensor(clips))._data
        paddle.set_device("gpu:0")
        layer = make()
        x = paddle.to_tensor(clips)
        with paddle.no_grad():
            ms, got = _event_ms(torch, lambda: layer(x))
        errs[name] = _rel_err(got._data, want)
        out[f"{name}_ms"] = ms
        out[f"{name}_clips_per_s"] = MEL_BATCH / (ms / 1e3)
        out[f"{name}_shape"] = list(got.shape)
        del got, want
    clip = paddle.to_tensor(clips[0])
    back = paddle.fft.irfft(paddle.fft.rfft(clip), n=MEL_SAMPLES)
    rt = float((back._data - clip._data).abs().max())
    run.check(all(e <= 1e-4 for e in errs.values()) and rt <= 1e-5,
              f"21e: LogMelSpectrogram and MFCC({MEL_MFCC}) at Whisper's "
              f"widths (B{MEL_BATCH} x {MEL_SAMPLES} samples) on the card "
              f"within 1e-4 of the CPU's largest value ({errs}); "
              f"paddle.fft.irfft(rfft(clip)) within 1e-5 ({rt:.2e})")
    print(f"21e: log-mel {out['log_mel_ms']:.3f} ms a batch "
          f"({out['log_mel_clips_per_s']:.1f} clips/s), MFCC "
          f"{out['mfcc_ms']:.3f} ms ({out['mfcc_clips_per_s']:.1f} clips/s)"
          f", shapes {out['log_mel_shape']} {out['mfcc_shape']}",
          flush=True)
    out["rel_err"] = errs
    out["fft_round_trip_err"] = rt
    return out


def drive_sparse_lookahead(run, paddle, GPTConfig, GPTForCausalLM, fa,
                           mods, torch):
    """21f: the Layer GPT at MEDIUM's widths (bf16, B4 S2048) pruned 2:4
    by asp.prune_model, trained by asp.decorate(LookAhead(AdamW(lr 1e-3,
    multi_precision), alpha 0.5, k 5)) for 6 steps with ModelAverage beside
    it (a pure-bf16 AdamW rounds beta2 = 0.999 to 1, as the reference's
    does, and its second step is NaN)."""
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.incubate.optimizer import LookAhead, ModelAverage
    L = MEDIUM["num_layers"]
    cfg = GPTConfig(**MEDIUM)
    paddle.seed(0)
    model = GPTForCausalLM(cfg)
    _gpt_normal_init(model, 21, torch)
    model.bfloat16()
    model.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = asp.prune_model(model)
    torch.cuda.synchronize()
    mask_ms = (time.perf_counter() - t0) * 1e3
    pruned = [p for p in model.parameters() if id(p) in masks]
    masks0 = {id(p): masks[id(p)].clone() for p in pruned}
    la = LookAhead(paddle.optimizer.AdamW(
        learning_rate=SPARSE_LR, parameters=model.parameters(),
        multi_precision=True), alpha=0.5, k=SPARSE_K)
    opt = asp.decorate(la)
    ma = ModelAverage(0.15, parameters=model.parameters())
    # CUDA events around LookAhead's step and its inner AdamW's: the sync
    # is the difference
    events = {"lookahead": [], "inner": []}

    def evented(fn, log):
        def call(*a, **k):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            out = fn(*a, **k)
            pair[1].record()
            log.append(pair)
            return out
        return call
    la.step = evented(la.step, events["lookahead"])
    la.inner_optimizer.step = evented(la.inner_optimizer.step,
                                      events["inner"])
    loss_fn = _lm_loss(paddle)
    ids = paddle.to_tensor(np.random.RandomState(27).randint(
        0, MEDIUM["vocab_size"], (MEDIUM_BATCH, MEDIUM_SEQ)))
    losses, step_ms = [], []
    dens_ok = launch_ok = synced = True
    want = {n: (L if n.startswith("library_flash") else 0)
            for n in _launches(mods)}
    for i in range(SPARSE_STEPS):
        _reset(mods)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = loss_fn(model(ids), ids)
        loss.backward()
        ev[1].record()
        opt.step()
        opt.clear_grad()
        ma.step()
        ev[2].record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        step_ms.append(ev[0].elapsed_time(ev[2]))
        launch_ok = launch_ok and _launches(mods) == want
        for p in pruned:
            m = masks[id(p)]
            dens = asp.calculate_density(p)
            dens_ok = dens_ok and torch.equal(m, masks0[id(p)]) \
                and not bool((p._data[~m] != 0).any()) \
                and 0.5 - 1e-4 <= dens <= 0.5
        if i + 1 < SPARSE_K:
            synced = synced and not la._slow
        elif i + 1 == SPARSE_K:
            # the slow weights of this step's sync (f32, from the master
            # weights) are the masters' and the parameters' values, the
            # masks applied again after the sync
            inner = la.inner_optimizer
            synced = synced and len(la._slow) == len(inner._parameter_list)
            for p in inner._parameter_list:
                slow = la._slow[id(p)]
                m = masks.get(id(p))
                slow = slow * m if m is not None else slow
                synced = synced and torch.equal(
                    slow, inner._master_weight(p)._data) and torch.equal(
                    slow.to(p._data.dtype), p._data)
    before = [p._data.clone() for p in model.parameters()]
    ma.apply()
    moved = any(not torch.equal(a, p._data)
                for a, p in zip(before, model.parameters()))
    ma.restore()
    restored = all(torch.equal(a, p._data)
                   for a, p in zip(before, model.parameters()))
    del before
    finite = all(math.isfinite(x) for x in losses)
    run.check(dens_ok, f"21f: every one of the {len(pruned)} pruned Linear "
              f"weights has density 0.5 in 2:4 groups after each of "
              f"{SPARSE_STEPS} steps, its mask unchanged")
    run.check(bool(synced), f"21f: LookAhead (k={SPARSE_K}) synced its "
              f"slow weights at step {SPARSE_K} (none before)")
    run.check(finite and losses[-1] < losses[0],
              f"21f: losses finite and falling: {losses}")
    run.check(moved and restored, "21f: ModelAverage.apply() put the "
              "averages in and restore() brought every parameter back bit "
              f"for bit (moved {moved}, restored {restored})")
    run.check(launch_ok, f"21f: {L} launches of each library kernel a step "
              f"and no other attention kernel, every step")
    outer, inner = ([a.elapsed_time(b) for a, b in events[k]]
                    for k in ("lookahead", "inner"))
    sync_ms = outer[SPARSE_K - 1] - inner[SPARSE_K - 1]
    other_ms = float(np.median([o - i for j, (o, i) in
                                enumerate(zip(outer, inner))
                                if j + 1 != SPARSE_K]))
    ms = float(np.median(step_ms[1:]))
    print(f"21f: 2:4-sparse LookAhead GPT (MEDIUM, bf16, B{MEDIUM_BATCH} "
          f"S{MEDIUM_SEQ}): {ms:.2f} ms a step (CUDA events, median of "
          f"steps 2-{SPARSE_STEPS}), {MEDIUM_BATCH * MEDIUM_SEQ / ms * 1e3:.1f}"
          f" tokens/s; prune_model {mask_ms:.2f} ms for {len(pruned)} "
          f"weights; the LookAhead sync {sync_ms:.2f} ms (step {SPARSE_K}'s "
          f"LookAhead.step less its AdamW step, CUDA events; "
          f"{other_ms:.2f} at the other steps); losses {losses}",
          flush=True)
    del model, la, opt, ma
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "step_ms": step_ms, "losses": losses,
            "mask_ms": mask_ms, "sync_ms": sync_ms,
            "no_sync_ms": other_ms,
            "pruned_weights": len(pruned)}


def drive_phase21(run, paddle, GPTConfig, GPTForCausalLM, mods, fa, torch):
    """Phase 21, the breadth slice: 21a-21f, each timed."""
    t_phase = time.perf_counter()
    out = {}
    for key, fn in (
            ("detection", lambda: drive_detection(run, paddle, torch)),
            ("dcn", lambda: drive_dcn(run, paddle, torch)),
            ("fused_llama", lambda: drive_fused_llama(run, paddle, fa, mods,
                                                      torch)),
            ("fused_moe", lambda: drive_fused_moe(run, paddle, torch)),
            ("log_mel", lambda: drive_logmel(run, paddle, torch)),
            ("sparse_lookahead", lambda: drive_sparse_lookahead(
                run, paddle, GPTConfig, GPTForCausalLM, fa, mods, torch))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t0
        print(f"21 {key}: {out[key]['phase_s']:.1f} s", flush=True)
        paddle.set_device("gpu:0")
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_21_s"] = time.perf_counter() - t_phase
    print(f"breadth phase: {out['phase_21_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 22
# the tail of the breadth: quantization, sparse, distribution and the small
# modules. CARD is the phase's device, the CPU the plain path beside it.
CARD, CARD_TYPE = "gpu:0", "cuda"
QAT_STEPS, QAT_LR = 4, 1e-3
PTQ_BATCH, PTQ_SEQ, PTQ_CALIB = 1, 2048, 2
PTQ_LOSS_TOL = 1e-2      # the converted loss against the bf16 model's, rel.
KITTI_GRID, KITTI_VOXELS, KITTI_CROP = (41, 1600, 1408), 16000, (41, 200, 176)
ARXIV = dict(nodes=169343, edges=1166243, feats=128, hidden=256, classes=40,
             train=90941)
GCN_STEPS, GCN_LR = 3, 0.01
DIST_SETS, DIST_DRAWS = 1 << 16, 1 << 20
# f32 on the card against the CPU: the same arithmetic in another order
# (cuDNN's and cuSPARSE's sums, the card's lgamma), relative to the largest
# value
TAIL_TOL = 1e-4
# 22a's small copy under 8-bit QAT, card against CPU: (loss relative,
# step-0 gradient of its leaf's scale, learned scale relative). A last-bit
# difference before a quanter can put a / s on the other side of .5 and
# move one activation by a step (1/127 of its tensor's abs-max): one such
# rounding moves a weight gradient by up to ~1/127 of its scale, and the
# step after it moves the next batch's abs-max (measured on an H100:
# 4.85e-5, 4.31e-3 and 8.58e-4)
QAT_SMALL_TOL = (1e-4, 1e-2, 2e-3)
# 22c's GCN: the card's f32 first-layer weight gradient against the CPU's
# f64 one, of its scale. At this size the CPU's own f32 gradient is 6.3e-4
# from its f64 one (BatchNorm's backward subtracts means over 169,343 rows)
GCN_GRAD_TOL = 2e-3


def _qat_config(Q, linears):
    """QAT's config of 22a: a channel-wise abs-max weight quanter and an
    abs-max activation quanter on each of ``linears``."""
    cfg = Q.QuantConfig()
    cfg.add_layer_config(linears,
                         activation=Q.quanter(Q.FakeQuanterWithAbsMax),
                         weight=Q.quanter(Q.FakeQuanterChannelWiseAbsMax))
    return cfg


def _block_linears(paddle, model):
    """The Linear layers of a model's blocks: every one but the head."""
    return [layer for name, layer in model.named_sublayers()
            if type(layer) is paddle.nn.Linear
            and not name.endswith("lm_head")]


def _act_scales(model):
    return {n: float(l.act_quanter._scale.numpy()[0])
            for n, l in model.named_sublayers() if hasattr(l, "act_quanter")}


def check_small_qat(run, paddle, GPTConfig, GPTForCausalLM, mods, torch):
    """22a's small copy: the 2-layer h256 Layer GPT under QAT (f32) on the
    card (the library kernels) against the CPU (plain attention), from one
    state_dict (GPT-2's N(0, 0.02)): the losses of 2 SGD steps, step 0's
    gradients and the learned activation scales."""
    Q = paddle.quantization
    cfg = GPTConfig(**SMALL_LAYER_GPT)
    L = cfg.num_layers
    rs = np.random.RandomState(22)
    ids = rs.randint(0, cfg.vocab_size, (2, 256))
    paddle.seed(0)
    paddle.set_device("cpu")
    state = {k: (rs.randn(*v.shape) * 0.02).astype(np.float32)
             if v.ndim >= 2 else v.numpy()
             for k, v in GPTForCausalLM(cfg).state_dict().items()}
    out, secs = {}, {}
    for dev in ("cpu", CARD):
        t0 = time.perf_counter()
        paddle.set_device(dev)
        model = GPTForCausalLM(cfg)
        model.set_state_dict(state)
        Q.QAT(_qat_config(Q, _block_linears(paddle, model))).quantize(
            model, inplace=True)
        opt = paddle.optimizer.SGD(0.1, parameters=model.parameters())
        losses = []
        for step in range(2):
            _reset(mods)
            t = paddle.to_tensor(ids)
            loss = model(t, t)
            loss.backward()
            if step == 0:
                grads = {n: p.grad.numpy()
                         for n, p in model.named_parameters()}
                launches = _launches(mods)
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        out[dev] = (losses, grads, _act_scales(model), launches)
        secs[dev] = time.perf_counter() - t0
    (lc, gc_, sc, _), (lg, gg, sg, launches) = out["cpu"], out[CARD]
    tol = QAT_SMALL_TOL
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    grad_err = max(_leaf_err(gg[n], gc_[n]) for n in gc_)
    scale_err = max(abs(sg[n] - sc[n]) / sc[n] for n in sc)
    tag = "22a small (QAT Layer GPT, 2 layers h256, f32, B2 S256)"
    run.check(launches == {n: L if n.startswith("library_flash") else 0
                           for n in launches},
              f"{tag}: {L} launches of each library kernel a step on the "
              f"card and no other ({launches})")
    run.check(loss_err <= tol[0] and grad_err <= tol[1]
              and scale_err <= tol[2] and len(sc) == 4 * L,
              f"{tag}: card against CPU: losses {lg} vs {lc} (worst "
              f"{loss_err:.2e}, tolerance {tol[0]}), step-0 gradients worst "
              f"{grad_err:.2e} of their leaf's scale (tolerance {tol[1]}), "
              f"the {len(sc)} learned activation scales worst "
              f"{scale_err:.2e} (tolerance {tol[2]})")
    paddle.set_device(CARD)
    print(f"22a small: {secs['cpu']:.1f} s on the CPU, {secs[CARD]:.1f} s "
          f"on the card (two steps each)", flush=True)
    return {"loss_rel_err": loss_err, "grad_err": grad_err,
            "scale_rel_err": scale_err, "cpu_s": secs["cpu"],
            "card_s": secs[CARD]}


def drive_qat_medium(run, paddle, GPTConfig, GPTForCausalLM, mods, torch):
    """22a: QAT of the Layer GPT at MEDIUM's widths (bf16, AdamW
    multi_precision, B4 S2048): a channel-wise weight quanter and an
    abs-max activation quanter on all 96 block Linears, 4 steps; then
    convert and eval forwards; ms/step beside the same model unquantized."""
    Q = paddle.quantization
    cfg = GPTConfig(**MEDIUM)
    L = cfg.num_layers
    paddle.set_device(CARD)
    ids = paddle.to_tensor(np.random.RandomState(22).randint(
        0, cfg.vocab_size, (MEDIUM_BATCH, MEDIUM_SEQ)))

    def build():
        paddle.seed(0)
        model = GPTForCausalLM(cfg)
        _gpt_normal_init(model, 22, torch)
        model.bfloat16()
        model.train()
        opt = paddle.optimizer.AdamW(learning_rate=QAT_LR,
                                     parameters=model.parameters(),
                                     multi_precision=True)
        return model, opt

    def steps(model, opt, n, want=None):
        losses, ms, ok = [], [], True
        for _ in range(n):
            _reset(mods)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss = model(ids, ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            ev[1].record()
            torch.cuda.synchronize()
            losses.append(float(loss))
            ms.append(ev[0].elapsed_time(ev[1]))
            ok = ok and (want is None or _launches(mods) == want)
        return losses, ms, ok

    model, opt = build()
    linears = _block_linears(paddle, model)
    qat = Q.QAT(_qat_config(Q, linears))
    qat.quantize(model, inplace=True)
    quanted = [l for _, l in model.named_sublayers()
               if isinstance(l, Q.QuantedLinear)]
    want = {n: (L if n.startswith("library_flash") else 0)
            for n in _launches(mods)}
    losses, qms, launch_ok = steps(model, opt, QAT_STEPS, want)
    scales = [q.act_quanter._scale._data for q in quanted]
    on_card = all(s.device.type == CARD_TYPE for s in scales) and all(
        q.inner.weight._data.device.type == CARD_TYPE for q in quanted)
    run.check(len(linears) == 4 * L and len(quanted) == 4 * L and on_card,
              f"22a: QAT wraps all {4 * L} block Linears of the MEDIUM GPT "
              f"({len(quanted)}), its quanters and weights on the card: "
              f"{on_card}")
    run.check(all(math.isfinite(x) for x in losses)
              and 10.0 <= losses[0] <= 11.5 and losses[-1] < losses[0],
              f"22a: QAT losses finite, step 0 near ln({cfg.vocab_size}) = "
              f"{math.log(cfg.vocab_size):.3f} (in [10, 11.5]) and falling: "
              f"{losses}")
    run.check(launch_ok, f"22a: each QAT step launches lf_fwd, lf_bwd_dq "
              f"and lf_bwd_dkv {L} times each and no other attention kernel")
    qat.convert(model, inplace=True)
    before = [s.clone() for s in scales]
    eval_ok = True
    with paddle.no_grad():
        for _ in range(2):
            _reset(mods)
            logits = model(ids)
            torch.cuda.synchronize()
            eval_ok = eval_ok and _launches(mods) == {
                n: (L if n == "library_flash_fwd" else 0)
                for n in _launches(mods)}
            finite = bool(torch.isfinite(logits._data).all())
            del logits
    frozen = all(torch.equal(a, q.act_quanter._scale._data)
                 for a, q in zip(before, quanted))
    run.check(eval_ok and frozen and finite and not model.training,
              f"22a: after convert, eval forwards launch lf_fwd {L} times "
              f"and no other attention kernel ({eval_ok}), the scales no "
              f"longer move ({frozen}), logits finite ({finite})")
    del model, opt, quanted, scales, before
    gc.collect()
    torch.cuda.empty_cache()
    plain, popt = build()
    _, pms, _ = steps(plain, popt, QAT_STEPS)
    del plain, popt
    gc.collect()
    torch.cuda.empty_cache()
    q_ms, p_ms = float(np.median(qms[1:])), float(np.median(pms[1:]))
    tps = MEDIUM_BATCH * MEDIUM_SEQ / q_ms * 1e3
    print(f"22a: QAT GPT (MEDIUM, bf16, B{MEDIUM_BATCH} S{MEDIUM_SEQ}, "
          f"{4 * L} quanted Linears): {q_ms:.2f} ms a step (CUDA events, "
          f"median of steps 2-{QAT_STEPS}), {tps:.1f} tokens/s; the same "
          f"model without quanters {p_ms:.2f} ms (the same steps); "
          f"losses {losses}", flush=True)
    return {"ms_per_step": q_ms, "step_ms": qms, "plain_ms_per_step": p_ms,
            "plain_step_ms": pms, "tokens_per_s": tps, "losses": losses,
            "quanted_linears": 4 * L}


def drive_ptq_llama(run, paddle, fa, mods, torch):
    """22b: PTQ of Llama-2-7B (bf16, all 32 layers): quantize, 2
    calibration forwards at B1 S2048, convert in place; the converted
    forward on a held-out batch against the unquantized loss."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    Q = paddle.quantization
    cfg = LlamaConfig.llama2_7b()
    L = cfg.num_layers
    paddle.set_device(CARD)
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    paddle.seed(0)
    model = LlamaForCausalLM(cfg)
    model.bfloat16()
    model.eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rs = np.random.RandomState(22)
    batches = [paddle.to_tensor(rs.randint(0, cfg.vocab_size,
                                           (PTQ_BATCH, PTQ_SEQ)))
               for _ in range(PTQ_CALIB + 1)]
    held = batches.pop()

    def f32_loss():
        """The next-token loss on the held-out batch from f32 logits (a
        bf16 loss near 10.5 moves in steps of 0.0625)."""
        with paddle.no_grad():
            logits = model(held).astype("float32")
            v = logits.shape[-1]
            return float(paddle.nn.functional.cross_entropy(
                logits[:, :-1].reshape([-1, v]),
                held[:, 1:].reshape([-1])))
    base = f32_loss()
    linears = _block_linears(paddle, model)
    qcfg = Q.QuantConfig()
    qcfg.add_layer_config(linears)
    ptq = Q.PTQ(qcfg)
    ptq.quantize(model, inplace=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with paddle.no_grad():
        for b in batches:
            model(b)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptq.convert(model, inplace=True)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    quanted = [l for _, l in model.named_sublayers()
               if isinstance(l, Q.QuantedLinear)]
    on_card = all(q.act_quanter._scale._data.device.type == CARD_TYPE
                  and q.weight_quanter._scale._data.device.type == CARD_TYPE
                  for q in quanted)
    run.check(len(quanted) == 7 * L and on_card,
              f"22b: convert(inplace=True) gives {len(quanted)} "
              f"QuantedLinears (want {7 * L}), their scales on the card: "
              f"{on_card}")
    _reset(mods)
    ticks0 = fa.dispatch_counts()
    torch.cuda.reset_peak_memory_stats()
    qloss = f32_loss()
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - held_before) / 1e9
    launches = _launches(mods)
    dispatch = fa.dispatch_counts(ticks0)
    run.check(launches == {n: (L if n == "library_flash_fwd" else 0)
                           for n in launches}
              and dispatch == {("nn.sdpa", "library_flash"): L},
              f"22b: the converted forward launches lf_fwd {L} times and "
              f"no other attention kernel ({launches}, dispatch "
              f"{dispatch})")
    rel = abs(qloss - base) / abs(base)
    run.check(math.isfinite(qloss) and rel <= PTQ_LOSS_TOL,
              f"22b: the int8 fake-quantized loss on a held-out batch "
              f"{qloss:.5f} against the bf16 model's {base:.5f}: {rel:.2e} "
              f"(bound {PTQ_LOSS_TOL})")

    def fwd():
        with paddle.no_grad():
            return model(held)
    ms, _ = _event_ms(torch, fwd, reps=3)
    del model, quanted, ptq
    gc.collect()
    torch.cuda.empty_cache()
    print(f"22b: PTQ Llama-2-7B (bf16, {7 * L} quanted Linears) B{PTQ_BATCH}"
          f" S{PTQ_SEQ}: the converted forward {ms:.2f} ms (CUDA events, "
          f"median of 3), peak {peak_gb:.2f} GB above what the phase held "
          f"(the weights included); loss {qloss:.5f} against "
          f"{base:.5f}; built in {build_s:.1f} s, {PTQ_CALIB} calibration "
          f"forwards {calib_s:.2f} s, convert {convert_s:.2f} s", flush=True)
    return {"ms": ms, "peak_gb": peak_gb, "loss": qloss, "base_loss": base,
            "loss_rel": rel, "calib_s": calib_s, "convert_s": convert_s,
            "build_s": build_s, "quanted_linears": 7 * L}


def kitti_voxels(rs, grid, n):
    """n distinct voxel sites of a [1, *grid] batch and 4 features each."""
    total = int(np.prod(grid))
    lin = np.unique(rs.randint(0, total, n + n // 2))
    lin = np.sort(rs.permutation(lin)[:n])
    z, y, x = np.unravel_index(lin, grid)
    idx = np.stack([np.zeros_like(z), z, y, x])
    return idx, rs.randn(len(lin), 4).astype(np.float32)


def second_stem(paddle, idx, feats, grid, dev):
    """SECOND's VoxelBackBone8x stem (OpenPCDet second.yaml): SubmConv3D
    4->16, BatchNorm (eps 1e-3, momentum 0.01 in torch's terms), ReLU, then
    Conv3D 16->32 stride 2, BatchNorm, ReLU; one forward and backward on
    ``dev``. The weights are the layers' own seeded draws."""
    sp = paddle.sparse
    paddle.set_device(dev)
    layers = [sp.nn.SubmConv3D(4, 16, 3, padding=1, bias_attr=False),
              sp.nn.BatchNorm(16, momentum=0.99, epsilon=1e-3),
              sp.nn.ReLU(),
              sp.nn.Conv3D(16, 32, 3, stride=2, padding=1, bias_attr=False),
              sp.nn.BatchNorm(32, momentum=0.99, epsilon=1e-3),
              sp.nn.ReLU()]

    def run_once():
        x = sp.sparse_coo_tensor(idx, feats, [1, *grid, 4])
        subm = layers[0](x)
        out = subm
        for layer in layers[1:]:
            out = layer(out)
        loss = (out.values() ** 2).mean()
        loss.backward()
        return x, subm, out, loss
    return layers, run_once


def drive_second(run, paddle, torch):
    """22c: SECOND's voxel stem at the full KITTI grid [41, 1600, 1408] with
    16,000 voxels on the card; a [41, 200, 176] crop of the same density on
    the card against the CPU."""
    rs = np.random.RandomState(22)
    idx, feats = kitti_voxels(rs, KITTI_GRID, KITTI_VOXELS)
    layers, once = second_stem(paddle, idx, feats, KITTI_GRID, CARD)
    x, subm, out, loss = once()
    torch.cuda.synchronize()
    sites = bool(torch.equal(subm._idx, x._idx))
    on_card = out._val.device.type == CARD_TYPE and all(
        l.weight.grad is not None and l.weight.grad._data.device.type ==
        CARD_TYPE for l in (layers[0], layers[3]))
    nnz = (x.nnz(), subm.nnz(), out.nnz())
    del x, subm, out, loss
    torch.cuda.empty_cache()
    # the first call was the warm-up: one timed call, one profiled (a call
    # takes seconds at this grid)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    once()
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    wall_ms, rows = _profiled(torch, once)
    busy = sum(r[1] for r in rows)
    top = [(k[:60], round(t, 3), c) for k, t, c in rows[:5]]
    run.check(sites and on_card,
              f"22c: SECOND's stem at [41, 1600, 1408] with {nnz[0]} "
              f"voxels: the submanifold output keeps exactly the input's "
              f"sites ({sites}); the values and the weights' gradients on "
              f"the card ({on_card}); {nnz[2]} nonzeros after the strided "
              f"conv")
    # the crop, card against CPU
    crop_n = round(KITTI_VOXELS * KITTI_CROP[1] * KITTI_CROP[2]
                   / (KITTI_GRID[1] * KITTI_GRID[2]))
    cidx, cfeats = kitti_voxels(np.random.RandomState(22), KITTI_CROP,
                                crop_n)
    res = {}
    for dev in ("cpu", CARD):
        cl, conce = second_stem(paddle, cidx, cfeats, KITTI_CROP, dev)
        _, _, cout, closs = conce()
        res[dev] = (cout._idx.cpu(), cout.to_dense().numpy(), float(closs),
                    [l.weight.grad.numpy() for l in (cl[0], cl[3])])
    (ic, dc, lc, gc_), (ig, dg, lg, gg) = res["cpu"], res[CARD]
    same_sites = bool(torch.equal(ic, ig))
    out_err = _leaf_err(dg, dc)
    grad_err = max(_leaf_err(a, b) for a, b in zip(gg, gc_))
    run.check(same_sites and out_err <= TAIL_TOL and grad_err <= TAIL_TOL
              and abs(lg - lc) <= TAIL_TOL * abs(lc),
              f"22c: the [41, 200, 176] crop ({crop_n} voxels) on the card "
              f"against the CPU: the same output sites ({same_sites}), "
              f"outputs {out_err:.2e}, both convolutions' weight gradients "
              f"{grad_err:.2e} of their scale, loss {lg:.6f} vs {lc:.6f} "
              f"(tolerance {TAIL_TOL})")
    paddle.set_device(CARD)
    print(f"22c: SECOND stem, KITTI grid, {nnz[0]} voxels: forward+backward"
          f" {ms:.2f} ms (CUDA events, after a first call), peak "
          f"{peak_gb:.2f} GB "
          f"above what the phase held (the dense block of the reference's "
          f"design); nnz in/subm/out {nnz}; one profiled call: "
          f"{wall_ms:.2f} ms wall, kernels {busy:.2f} ms (idle "
          f"{1 - busy / wall_ms:.3f}), the top kernels {top}", flush=True)
    return {"ms": ms, "peak_gb": peak_gb, "nnz": list(nnz),
            "profiled_wall_ms": wall_ms, "kernel_ms": busy, "top": top,
            "crop_out_err": out_err, "crop_grad_err": grad_err}


def arxiv_graph(rs):
    """A random graph at ogbn-arxiv's size, made symmetric with self-loops,
    its normalised adjacency D^-1/2 (A + I) D^-1/2, features, labels and a
    training split of arxiv's size."""
    n, e = ARXIV["nodes"], ARXIV["edges"]
    src, dst = rs.randint(0, n, e), rs.randint(0, n, e)
    keys = np.unique(np.concatenate([src * n + dst, dst * n + src,
                                     np.arange(n) * (n + 1)]))
    row, col = keys // n, keys % n
    deg = np.bincount(row, minlength=n).astype(np.float64)
    val = (1.0 / np.sqrt(deg[row] * deg[col])).astype(np.float32)
    x = rs.randn(n, ARXIV["feats"]).astype(np.float32)
    y = rs.randint(0, ARXIV["classes"], n)
    train = np.sort(rs.permutation(n)[:ARXIV["train"]])
    return np.stack([row, col]), val, x, y, train


def gcn_model(paddle):
    """OGB's arxiv GCN (examples/nodeproppred/arxiv/gnn.py): 3 GCNConv
    layers of 256 (a Linear, the normalised adjacency, a bias), BatchNorm
    and ReLU between them; dropout left out so the step can be held
    against the CPU."""
    nn = paddle.nn
    dims = [ARXIV["feats"], ARXIV["hidden"], ARXIV["hidden"],
            ARXIV["classes"]]

    class GCN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lins = nn.LayerList([nn.Linear(a, b, bias_attr=False)
                                      for a, b in zip(dims, dims[1:])])
            for i, b in enumerate(dims[1:]):
                setattr(self, f"bias_{i}",
                        self.create_parameter([b], is_bias=True))
            self.bns = nn.LayerList([nn.BatchNorm1D(ARXIV["hidden"])
                                     for _ in range(2)])

        def forward(self, adj, x):
            for i, lin in enumerate(self.lins):
                x = paddle.sparse.matmul(adj, lin(x)) \
                    + getattr(self, f"bias_{i}")
                if i < 2:
                    x = paddle.nn.functional.relu(self.bns[i](x))
            return x
    return GCN()


def drive_gcn(run, paddle, torch):
    """22c: the GCN at ogbn-arxiv's size (169,343 nodes, 1,166,243 edges
    from seed 22, symmetric with self-loops; 128 features, 3 layers of 256,
    40 classes), Adam at lr 0.01 for 3 steps on the card; step 0's loss and
    the first layer's weight gradient against the CPU (f64) at the same
    size."""
    sp = paddle.sparse
    idx, val, x, y, train = arxiv_graph(np.random.RandomState(22))
    paddle.seed(0)
    paddle.set_device("cpu")
    state = {k: v.numpy() for k, v in gcn_model(paddle).state_dict().items()}
    out = {}
    for dev in ("cpu", CARD):
        # the CPU's reference in f64, the card in f32
        dt = "float64" if dev == "cpu" else "float32"
        paddle.set_device(dev)
        model = gcn_model(paddle)
        model.set_state_dict(state)
        model.to(dtype=dt)
        adj = sp.sparse_coo_tensor(idx, val, [ARXIV["nodes"]] * 2, dtype=dt)
        xt, yt = paddle.to_tensor(x, dtype=dt), paddle.to_tensor(y[train])
        tr = paddle.to_tensor(train)
        opt = paddle.optimizer.Adam(learning_rate=GCN_LR,
                                    parameters=model.parameters())
        losses, ms = [], []
        for step in range(GCN_STEPS if dev == CARD else 1):
            t0 = time.perf_counter()
            logits = model(adj, xt)
            loss = paddle.nn.functional.cross_entropy(
                paddle.gather(logits, tr), yt)
            loss.backward()
            if step == 0:
                grad = model.lins[0].weight.grad.numpy()
                on_dev = logits._data.device.type
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[dev] = (losses, grad, on_dev, ms, adj.nnz())
        del model, adj, opt, logits, loss
    (lc, gc_, _, _, nnz), (lg, gg, dev_type, ms, _) = out["cpu"], out[CARD]
    loss_err = abs(lg[0] - lc[0]) / abs(lc[0])
    grad_err = _leaf_err(gg, gc_)
    run.check(dev_type == CARD_TYPE and all(math.isfinite(v) for v in lg)
              and lg[-1] < lg[0],
              f"22c: the arxiv-size GCN's sparse.matmul runs on the card "
              f"({dev_type}); losses finite and falling over {GCN_STEPS} "
              f"Adam steps: {lg}")
    run.check(loss_err <= TAIL_TOL and grad_err <= GCN_GRAD_TOL,
              f"22c: step 0 on the card (f32) against the CPU (f64; {nnz} "
              f"stored entries): loss {lg[0]:.7f} vs {lc[0]:.7f} "
              f"({loss_err:.2e}, tolerance {TAIL_TOL}), the first layer's "
              f"weight gradient {grad_err:.2e} of its scale (tolerance "
              f"{GCN_GRAD_TOL})")
    paddle.set_device(CARD)
    step_ms = float(np.median(ms[1:]))
    print(f"22c: GCN at ogbn-arxiv's size ({ARXIV['nodes']} nodes, {nnz} "
          f"stored entries of the normalised adjacency): {step_ms:.2f} ms a "
          f"step (host clock with the loss read, median of steps "
          f"2-{GCN_STEPS}); losses {lg}", flush=True)
    return {"ms_per_step": step_ms, "step_ms": ms, "losses": lg,
            "adj_nnz": nnz, "loss_rel_err": loss_err, "grad_err": grad_err}


def dist_cases(rs, n):
    """name -> (numpy parameters, build(D, t, params), a value of each
    parameter set's support) of every family, at n parameter sets."""
    def pos(*s):
        return (rs.rand(n, *s) * 2 + 0.5).astype(np.float32)

    def unit(*s):
        return (rs.rand(n, *s) * 0.8 + 0.1).astype(np.float32)

    def normal(*s):
        return rs.randn(n, *s).astype(np.float32)
    a = rs.randn(n, 3, 3)
    cov = a @ a.transpose(0, 2, 1) + 3 * np.eye(3)
    tril = np.linalg.cholesky(cov).astype(np.float32)
    s = np.sqrt(np.einsum("nii->ni", cov))
    lkj = np.linalg.cholesky(cov / s[:, :, None] / s[:, None, :]).astype(
        np.float32)
    counts = np.stack([rs.multinomial(5, [0.2, 0.3, 0.5]) for _ in range(8)])
    mult = counts[rs.randint(0, 8, n)].astype(np.float32)
    probs3 = np.full((n, 3), [0.2, 0.3, 0.5], np.float32)
    lo, hi = -pos(), pos()
    return {
        "Normal": ((normal(), pos()), lambda D, t, p: D.Normal(*map(t, p)),
                   normal()),
        "Uniform": ((lo, hi), lambda D, t, p: D.Uniform(*map(t, p)),
                    lo + (hi - lo) * unit()),
        "Bernoulli": ((unit(),), lambda D, t, p: D.Bernoulli(t(p[0])),
                      (rs.rand(n) < 0.5).astype(np.float32)),
        "Categorical": ((normal(5),),
                        lambda D, t, p: D.Categorical(logits=t(p[0])),
                        rs.randint(0, 5, n)),
        "Exponential": ((pos(),), lambda D, t, p: D.Exponential(t(p[0])),
                        pos()),
        "Gamma": ((pos(), pos()), lambda D, t, p: D.Gamma(*map(t, p)), pos()),
        "Beta": ((pos(), pos()), lambda D, t, p: D.Beta(*map(t, p)), unit()),
        "Dirichlet": ((pos(3),), lambda D, t, p: D.Dirichlet(t(p[0])),
                      probs3),
        "Laplace": ((normal(), pos()), lambda D, t, p: D.Laplace(*map(t, p)),
                    normal()),
        "Gumbel": ((normal(), pos()), lambda D, t, p: D.Gumbel(*map(t, p)),
                   normal()),
        "LogNormal": ((normal(), pos()),
                      lambda D, t, p: D.LogNormal(*map(t, p)), pos()),
        "Multinomial": ((probs3,),
                        lambda D, t, p: D.Multinomial(5, t(p[0])), mult),
        "Geometric": ((unit(),), lambda D, t, p: D.Geometric(t(p[0])),
                      rs.randint(1, 6, n).astype(np.float32)),
        "Poisson": ((pos() * 20,), lambda D, t, p: D.Poisson(t(p[0])),
                    rs.randint(0, 40, n).astype(np.float32)),
        "Binomial": ((np.full(n, 10.0, np.float32), unit()),
                     lambda D, t, p: D.Binomial(*map(t, p)),
                     rs.randint(0, 11, n).astype(np.float32)),
        "Cauchy": ((normal(), pos()), lambda D, t, p: D.Cauchy(*map(t, p)),
                   normal()),
        "Chi2": ((pos() * 3,), lambda D, t, p: D.Chi2(t(p[0])), pos()),
        "StudentT": ((pos() * 3, normal(), pos()),
                     lambda D, t, p: D.StudentT(*map(t, p)), normal()),
        "MultivariateNormal": ((normal(3), tril),
                               lambda D, t, p: D.MultivariateNormal(
                                   t(p[0]), scale_tril=t(p[1])), normal(3)),
        "ContinuousBernoulli": ((unit(),),
                                lambda D, t, p: D.ContinuousBernoulli(
                                    t(p[0])), unit()),
        "Independent": ((normal(4), pos(4)),
                        lambda D, t, p: D.Independent(D.Normal(*map(t, p)),
                                                      1), normal(4)),
        "TransformedDistribution": (
            (normal(), pos()),
            lambda D, t, p: D.TransformedDistribution(
                D.Normal(*map(t, p)), [D.AffineTransform(
                    t(np.float32(0.5)), t(np.float32(2.0))),
                    D.ExpTransform()]), pos()),
        "LKJCholesky": ((pos(),), lambda D, t, p: D.LKJCholesky(3, t(p[0])),
                        lkj),
    }


# name -> (scalar parameters, build(D, t), mean, variance) for 22d's draws
DIST_MOMENTS = {
    "Normal": (lambda D, t: D.Normal(t(0.5), t(1.5)), 0.5, 2.25),
    "Uniform": (lambda D, t: D.Uniform(t(-1.0), t(3.0)), 1.0, 16 / 12),
    "Bernoulli": (lambda D, t: D.Bernoulli(t(0.3)), 0.3, 0.21),
    "Exponential": (lambda D, t: D.Exponential(t(2.0)), 0.5, 0.25),
    "Gamma": (lambda D, t: D.Gamma(t(2.5), t(2.0)), 1.25, 0.625),
    "Beta": (lambda D, t: D.Beta(t(2.0), t(3.0)), 0.4, 0.04),
    "Laplace": (lambda D, t: D.Laplace(t(0.5), t(1.5)), 0.5, 4.5),
    "Gumbel": (lambda D, t: D.Gumbel(t(0.5), t(1.5)),
               0.5 + 0.5772156649015329 * 1.5, math.pi ** 2 / 6 * 2.25),
    "Geometric": (lambda D, t: D.Geometric(t(0.3)), 1 / 0.3, 0.7 / 0.09),
    "Poisson": (lambda D, t: D.Poisson(t(7.5)), 7.5, 7.5),
    "Binomial": (lambda D, t: D.Binomial(t(10.0), t(0.3)), 3.0, 2.1),
    "Chi2": (lambda D, t: D.Chi2(t(3.0)), 3.0, 6.0),
    "StudentT": (lambda D, t: D.StudentT(t(10.0), t(0.5), t(1.5)), 0.5,
                 2.25 * 10 / 8),
    "ContinuousBernoulli": (lambda D, t: D.ContinuousBernoulli(t(0.3)),
                            None, None),
}


def drive_distributions(run, paddle, torch):
    """22d: every family's log_prob (and entropy, where it has one) on the
    card on 2^16 parameter sets against the CPU on the same parameters;
    the mean and variance of 2^20 draws on the card within 6 standard
    errors of the family's."""
    D = paddle.distribution
    cases = dist_cases(np.random.RandomState(22), DIST_SETS)
    errs, worst = {}, 0.0
    t0 = time.perf_counter()
    for name, (params, build, value) in cases.items():
        got = {}
        for dev in ("cpu", CARD):
            paddle.set_device(dev)
            d = build(D, paddle.to_tensor, params)
            vals = [d.log_prob(paddle.to_tensor(value))]
            try:
                vals.append(d.entropy())
            except NotImplementedError:
                pass
            got[dev] = ([v._data.device.type for v in vals],
                        [v.numpy() for v in vals])
        devs, card = got[CARD]
        e = max(_leaf_err(a, b) for a, b in zip(card, got["cpu"][1]))
        finite = all(np.isfinite(a).all() for a in card)
        errs[name] = e
        worst = max(worst, e)
        what = "log_prob and entropy" if len(card) == 2 else "log_prob"
        run.check(set(devs) == {CARD_TYPE} and finite and e <= TAIL_TOL,
                  f"22d: {name}'s {what} on "
                  f"{DIST_SETS} parameter sets: card against CPU {e:.2e} "
                  f"of the largest value (tolerance {TAIL_TOL}), finite "
                  f"{finite}, on {sorted(set(devs))}")
    lp_s = time.perf_counter() - t0
    paddle.set_device(CARD)
    t0 = time.perf_counter()
    moments = {}
    for name, (build, mean, var) in DIST_MOMENTS.items():
        d = build(D, lambda v: paddle.to_tensor(np.float32(v)))
        s = d.sample([DIST_DRAWS])._data.double()
        if mean is None:
            mean = float(d.mean)
            var = None
        m, v = float(s.mean()), float(s.var())
        blocks = s.reshape(32, -1).var(1)
        se_m = math.sqrt((var if var is not None else v) / DIST_DRAWS)
        se_v = float(blocks.std()) / math.sqrt(32)
        ok = abs(m - mean) <= 6 * se_m and (
            var is None or abs(v - var) <= 6 * se_v) and \
            s.device.type == CARD_TYPE
        moments[name] = (m, v)
        run.check(ok, f"22d: {name}: 2^20 draws on the card, mean {m:.5f} "
                  f"(want {mean:.5f}, 6 SE {6 * se_m:.5f}), variance "
                  f"{v:.5f} (want {var}, 6 SE {6 * se_v:.5f})")
    torch.cuda.synchronize()
    draws_s = time.perf_counter() - t0
    print(f"22d: {len(cases)} families' log_prob and entropy at "
          f"{DIST_SETS} parameter sets on the card and the CPU in "
          f"{lp_s:.2f} s (worst {worst:.2e}); {len(DIST_MOMENTS)} families' "
          f"2^20 draws in {draws_s:.2f} s", flush=True)
    return {"rel_err": errs, "moments": moments, "log_prob_s": lp_s,
            "draws_s": draws_s}


def drive_tail_rest(run, paddle, GPTConfig, GPTForCausalLM, torch):
    """22e: utils.run_check on the card, a dlpack round trip, a host C++
    extension and a custom op on card tensors, onnx.export of the 2-layer
    GPT, version.cuda()."""
    import contextlib
    import ctypes
    import io as _io
    from paddle_tpu_torch.jit import InputSpec
    from paddle_tpu_torch.utils import cpp_extension, dlpack
    paddle.set_device(CARD)
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = paddle.utils.run_check()
    name = torch.cuda.get_device_name(0)
    run.check(ok and name in buf.getvalue(),
              f"22e: utils.run_check() names the card: "
              f"{buf.getvalue().strip()}")
    x = paddle.randn([1024, 1024])
    y = dlpack.from_dlpack(dlpack.to_dlpack(x))
    run.check(y._data.data_ptr() == x._data.data_ptr()
              and y._data.device.type == CARD_TYPE,
              "22e: a dlpack round trip of a card tensor keeps its "
              "data_ptr and device")
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "axpy.cc")
        with open(src, "w") as f:
            f.write('extern "C" double axpy(double a, double x, double y)'
                    " { return a * x + y; }\n")
        t0 = time.perf_counter()
        lib = cpp_extension.load("axpy", [src], build_directory=d)
        build_s = time.perf_counter() - t0
        lib.axpy.restype = ctypes.c_double
        host = lib.axpy(ctypes.c_double(2.0), ctypes.c_double(3.0),
                        ctypes.c_double(1.0))
        op = cpp_extension.register_op(
            "cube", forward=lambda a: a * a * a,
            backward=lambda a, g: 3 * a * a * g)
        v = paddle.to_tensor(np.linspace(-2, 2, 4096, dtype=np.float32),
                             stop_gradient=False)
        out = op(v)
        out.sum().backward()
        want = 3 * v._data.detach() ** 2
        run.check(host == 7.0 and out._data.device.type == CARD_TYPE
                  and torch.allclose(v.grad._data, want)
                  and torch.allclose(out._data, v._data.detach() ** 3),
                  f"22e: cpp_extension.load built a host source with g++ "
                  f"({build_s:.2f} s; axpy {host}), a register_op op ran its"
                  f" forward and backward on card tensors")
        cfg = GPTConfig(**SMALL_LAYER_GPT)
        paddle.seed(0)
        gpt = GPTForCausalLM(cfg)
        gpt.eval()
        t0 = time.perf_counter()
        path = paddle.onnx.export(gpt, os.path.join(d, "gpt2l"), input_spec=[
            InputSpec([None, cfg.max_seq_len], "int64")])
        export_s = time.perf_counter() - t0
        with open(path) as f:
            text = f.read()
    run.check("graph" in text and "library_flash" in text,
              f"22e: onnx.export of the 2-layer GPT wrote its graph text "
              f"({len(text)} characters, {export_s:.1f} s) with the "
              f"library attention op in it")
    run.check(paddle.version.cuda() == torch.version.cuda,
              f"22e: version.cuda() {paddle.version.cuda()} equals "
              f"torch.version.cuda {torch.version.cuda}; cudnn "
              f"{paddle.version.cudnn()}, nccl {paddle.version.nccl()}")
    return {"cpp_build_s": build_s, "onnx_export_s": export_s}


def drive_phase22(run, paddle, GPTConfig, GPTForCausalLM, mods, fa, torch):
    """Phase 22, the tail of the breadth: 22a-22e, each timed."""
    t_phase = time.perf_counter()
    out = {}
    for key, fn in (
            ("qat_small", lambda: check_small_qat(
                run, paddle, GPTConfig, GPTForCausalLM, mods, torch)),
            ("qat_medium", lambda: drive_qat_medium(
                run, paddle, GPTConfig, GPTForCausalLM, mods, torch)),
            ("ptq_llama", lambda: drive_ptq_llama(run, paddle, fa, mods,
                                                  torch)),
            ("second", lambda: drive_second(run, paddle, torch)),
            ("gcn", lambda: drive_gcn(run, paddle, torch)),
            ("distribution", lambda: drive_distributions(run, paddle,
                                                         torch)),
            ("rest", lambda: drive_tail_rest(run, paddle, GPTConfig,
                                             GPTForCausalLM, torch))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t0
        print(f"22 {key}: {out[key]['phase_s']:.1f} s", flush=True)
        paddle.set_device(CARD)
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_22_s"] = time.perf_counter() - t_phase
    print(f"tail phase: {out['phase_22_s']:.1f} s", flush=True)
    return out


def main():
    if sys.argv[1:2] == ["--phase16d-worker"]:
        phase16d_worker(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--phase17c-worker"]:
        phase17c_worker(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--phase18b-worker"]:
        phase18b_worker(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--phase19-worker"]:
        phase19_worker(sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--phase20a-client"]:
        phase20a_client(*sys.argv[2:5])
        return 0
    if sys.argv[1:2] == ["--phase20b-server"]:
        phase20b_server()
        return 0
    if sys.argv[1:2] == ["--phase20c-worker"]:
        phase20c_worker(sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--phase20e-worker"]:
        phase20e_worker(sys.argv[2])
        return 0
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "the card only", file=sys.stderr)
        return 1
    try:
        from paddle_tpu_torch.cost_model import cost_model
        from paddle_tpu_torch.models import gpt_hybrid as TH
        from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
        from paddle_tpu_torch.ops.hopper import _build
        from paddle_tpu_torch.ops.hopper import autotune as at
        from paddle_tpu_torch.ops.hopper import blocked_flash as bf
        from paddle_tpu_torch.ops.hopper import causal_attention as ca
        from paddle_tpu_torch.ops.hopper import flash_attention as fa
        from paddle_tpu_torch.ops.hopper import simple_attention as sa
        from paddle_tpu_torch.ops.hopper import simple_attention2 as sa2
        import paddle_tpu_torch as paddle
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})",
              file=sys.stderr)
        return 1
    # f32 products and convolutions in f32: what FLAGS_matmul_precision's
    # default gives a user (the port sets torch's and cuDNN's precision
    # from it); phase 12b also runs TF32 steps under "default"
    paddle.set_flags({"FLAGS_matmul_precision": "highest"})
    t_script = time.perf_counter()
    run = Run()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)} "
          f"(nvcc, sm_90a)", flush=True)
    for name, log in logs.items():
        rows = ptxas_rows(log)
        print(f"  {name}: {len(rows)} kernels, at most "
              f"{max((r for _, r, _ in rows), default=0)} registers a "
              f"thread, {sum(sp for _, _, sp in rows)} bytes spilled")
        for kernel, regs, spill in rows:
            if kernel.startswith("mma_"):
                print(f"    {kernel}: {regs} registers, {spill} bytes "
                      "spilled")
    # the kernels' libraries launch through torch's CUDA runtime: one
    # libcudart in the process (a static runtime in each library hid their
    # launches' rows from a profile's first steps, phase 20f)
    for name in _build.SOURCES:
        _build.library(name)
    with open("/proc/self/maps") as maps:
        cudarts = sorted({line.split()[-1] for line in maps
                          if "libcudart" in line})
    run.check(len(cudarts) == 1, f"build: the kernels' libraries and torch "
              f"share one CUDA runtime: {cudarts}")

    cache_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              ".cache")
    os.makedirs(cache_root, exist_ok=True)
    mods = (sa, ca, bf, sa2, fa)
    if "--phase22" in sys.argv[1:]:
        # phase 22 alone (no kernels line, no ok line): for work on it
        with tempfile.TemporaryDirectory(dir=cache_root) as cache:
            os.environ["PADDLE_TPU_CACHE_DIR"] = cache
            at._table = None
            tail = drive_phase22(run, paddle, GPTConfig, GPTForCausalLM,
                                 mods, fa, torch)
        print(json.dumps({"tail": tail}))
        print(f"chip_smoke --phase22: {time.perf_counter() - t_script:.1f} "
              f"s, {len(run.failures)} check(s) failed", flush=True)
        for what in run.failures:
            print(f"  {what[:300]}", file=sys.stderr)
        return 1 if run.failures else 0
    if "--phase21" in sys.argv[1:]:
        # phase 21 alone (no kernels line, no ok line): for work on it
        with tempfile.TemporaryDirectory(dir=cache_root) as cache:
            os.environ["PADDLE_TPU_CACHE_DIR"] = cache
            at._table = None
            br = drive_phase21(run, paddle, GPTConfig, GPTForCausalLM, mods,
                               fa, torch)
        print(json.dumps({"breadth": br}))
        print(f"chip_smoke --phase21: {time.perf_counter() - t_script:.1f} "
              f"s, {len(run.failures)} check(s) failed", flush=True)
        for what in run.failures:
            print(f"  {what[:300]}", file=sys.stderr)
        return 1 if run.failures else 0
    if "--phase20" in sys.argv[1:]:
        # phase 20 alone (no kernels line, no ok line): for work on it
        with tempfile.TemporaryDirectory(dir=cache_root) as cache:
            os.environ["PADDLE_TPU_CACHE_DIR"] = cache
            at._table = None
            hr = drive_phase20(run, paddle, GPTConfig, GPTForCausalLM, mods,
                               fa, torch)
        print(json.dumps({"host_runtime": hr}))
        print(f"chip_smoke --phase20: {time.perf_counter() - t_script:.1f} "
              f"s, {len(run.failures)} check(s) failed", flush=True)
        for what in run.failures:
            print(f"  {what[:300]}", file=sys.stderr)
        return 1 if run.failures else 0
    if "--phase19" in sys.argv[1:]:
        # phase 19 alone (no kernels line, no ok line): for work on it
        with tempfile.TemporaryDirectory(dir=cache_root) as cache:
            os.environ["PADDLE_TPU_CACHE_DIR"] = cache
            at._table = None
            ep, ap = drive_phase19(run, paddle, TH, GPTConfig,
                                   GPTForCausalLM, mods, fa, cost_model,
                                   torch)
        print(json.dumps({"expert_parallel": ep}))
        print(json.dumps({"auto_parallel": ap}))
        print(f"chip_smoke --phase19: {time.perf_counter() - t_script:.1f} "
              f"s, {len(run.failures)} check(s) failed", flush=True)
        for what in run.failures:
            print(f"  {what[:300]}", file=sys.stderr)
        return 1 if run.failures else 0
    if "--phase18" in sys.argv[1:]:
        # phase 18 alone (no kernels line, no ok line): for work on it
        with tempfile.TemporaryDirectory(dir=cache_root) as cache:
            os.environ["PADDLE_TPU_CACHE_DIR"] = cache
            at._table = None
            pp = drive_pipeline(run, paddle, TH, GPTConfig, torch)
        print(json.dumps({"pipeline": pp}))
        print(f"chip_smoke --phase18: {time.perf_counter() - t_script:.1f} "
              f"s, {len(run.failures)} check(s) failed", flush=True)
        for what in run.failures:
            print(f"  {what[:300]}", file=sys.stderr)
        return 1 if run.failures else 0
    if "--phase17" in sys.argv[1:]:
        # phase 17 alone (no kernels line, no ok line): for work on it
        with tempfile.TemporaryDirectory(dir=cache_root) as cache:
            os.environ["PADDLE_TPU_CACHE_DIR"] = cache
            at._table = None
            tp = drive_tensor_parallel(run, paddle, TH, GPTConfig, mods,
                                       cost_model, torch)
        print(json.dumps({"tensor_parallel": tp}))
        print(f"chip_smoke --phase17: {time.perf_counter() - t_script:.1f} "
              f"s, {len(run.failures)} check(s) failed", flush=True)
        for what in run.failures:
            print(f"  {what[:300]}", file=sys.stderr)
        return 1 if run.failures else 0
    if "--phase16" in sys.argv[1:]:
        # phase 16 alone (no kernels line, no ok line): for work on it
        with tempfile.TemporaryDirectory(dir=cache_root) as cache:
            os.environ["PADDLE_TPU_CACHE_DIR"] = cache
            at._table = None
            dd = drive_distributed(run, paddle, TH, GPTConfig,
                                   GPTForCausalLM, mods, fa, cost_model,
                                   torch)
        print(json.dumps({"distributed": dd}))
        print(f"chip_smoke --phase16: {time.perf_counter() - t_script:.1f} "
              f"s, {len(run.failures)} check(s) failed", flush=True)
        for what in run.failures:
            print(f"  {what[:300]}", file=sys.stderr)
        return 1 if run.failures else 0
    if "--phase15" in sys.argv[1:]:
        # phase 15 alone (no kernels line, no ok line): for work on it
        with tempfile.TemporaryDirectory(dir=cache_root) as cache:
            os.environ["PADDLE_TPU_CACHE_DIR"] = cache
            at._table = None
            api = drive_eager_api(run, paddle, TH, GPTConfig, mods, fa,
                                  torch)
        print(json.dumps({"eager_api": api}))
        print(f"chip_smoke --phase15: {time.perf_counter() - t_script:.1f} "
              f"s, {len(run.failures)} check(s) failed", flush=True)
        for what in run.failures:
            print(f"  {what[:300]}", file=sys.stderr)
        return 1 if run.failures else 0
    if "--phase14" in sys.argv[1:]:
        # phase 14 alone (no kernels line, no ok line): for work on it
        with tempfile.TemporaryDirectory(dir=cache_root) as cache:
            os.environ["PADDLE_TPU_CACHE_DIR"] = cache
            at._table = None
            jit = drive_jit(run, paddle, fa, mods, torch, None, cache_root)
        print(json.dumps({"jit": jit}))
        print(f"chip_smoke --phase14: {time.perf_counter() - t_script:.1f} "
              f"s, {len(run.failures)} check(s) failed", flush=True)
        return 1 if run.failures else 0
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        errs = check_kernels(run, mods, torch)
        check_small_model(run, TH, GPTConfig, torch)
        paths = {}
        for path in PATHS:
            paths[path[0]] = drive(run, path, TH, GPTConfig, mods, fa,
                                   cost_model, torch)
            torch.cuda.empty_cache()
        times = time_kernels(mods, torch)
        torch.cuda.synchronize()
        tuned = check_autotune(run, mods, fa, at, torch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        check_eager_attention(run, paddle, mods, fa, torch)
        eager = drive_eager_gpt(run, paddle, TH, GPTConfig, mods, fa, torch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        check_small_layer_gpt(run, paddle, GPTConfig, GPTForCausalLM, fa,
                              mods, torch)
        check_library_cross(run, fa, torch)
        torch.cuda.empty_cache()
        layer = drive_layer_gpt(run, paddle, GPTConfig, GPTForCausalLM, fa,
                                mods, torch)
    paths["layer_gpt"] = layer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    small_serving = check_small_serving(run, paddle, torch)
    serving = drive_serving(run, paddle, fa, mods, torch)
    serving["small"] = small_serving
    serving["phase_s"] = time.perf_counter() - t0
    print(f"serving phase: {serving['phase_s']:.1f} s", flush=True)
    # phase 9's 7B model is left to the cycle collector: without this the
    # next phase's peak memory read 13.48 GB (its weights) higher
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        t0 = time.perf_counter()
        check_small_moe(run, TH, GPTConfig, mods, torch)
        torch.cuda.empty_cache()
        moe = drive(run, MOE_PATH, TH, GPTConfig, mods, fa, cost_model,
                    torch, experts=MOE_EXPERTS)
        moe["phase_s"] = time.perf_counter() - t0
        print(f"moe phase: {moe['phase_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        t0 = time.perf_counter()
        check_small_bert(run, paddle, fa, mods, torch)
        bert_attn = time_library_at_bert(run, fa, torch)
        torch.cuda.empty_cache()
        bert = drive_bert(run, paddle, fa, mods, torch)
        bert["library_fwd_at_bert"] = bert_attn
        bert["phase_s"] = time.perf_counter() - t0
        print(f"bert phase: {bert['phase_s']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    small_resnet = check_small_resnet(run, paddle, torch)
    resnet = drive_resnet50(run, paddle, torch)
    resnet["small"] = small_resnet
    resnet["loader"] = check_forked_loader(run, paddle, torch)
    resnet["phase_12_s"] = time.perf_counter() - t0
    print(f"resnet phase: {resnet['phase_12_s']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        t0 = time.perf_counter()
        small_fit = check_small_fit(run, paddle, torch)
        fit = drive_model_fit(run, paddle, fa, mods, torch)
        fit["small"] = small_fit
        fit["phase_13_s"] = time.perf_counter() - t0
        print(f"model.fit phase: {fit['phase_13_s']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        jit = drive_jit(run, paddle, fa, mods, torch, fit["ms_per_step"],
                        cache_root)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        api = drive_eager_api(run, paddle, TH, GPTConfig, mods, fa, torch,
                              eager, layer)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        dd = drive_distributed(run, paddle, TH, GPTConfig, GPTForCausalLM,
                               mods, fa, cost_model, torch,
                               paths["flagship"], layer)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        tp = drive_tensor_parallel(run, paddle, TH, GPTConfig, mods,
                                   cost_model, torch)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        pp = drive_pipeline(run, paddle, TH, GPTConfig, torch)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        ep, ap = drive_phase19(run, paddle, TH, GPTConfig, GPTForCausalLM,
                               mods, fa, cost_model, torch, moe,
                               paths["flagship"], fit)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        hr = drive_phase20(run, paddle, GPTConfig, GPTForCausalLM, mods, fa,
                           torch)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        br = drive_phase21(run, paddle, GPTConfig, GPTForCausalLM, mods, fa,
                           torch)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=cache_root) as cache:
        os.environ["PADDLE_TPU_CACHE_DIR"] = cache
        at._table = None
        tail = drive_phase22(run, paddle, GPTConfig, GPTForCausalLM, mods,
                             fa, torch)

    kernels = []
    for kern in KERNELS:
        name, source, line, label, *_, library = kern
        launches = paths[label]["launches"][name]
        bound_ms, bound_by = bound(kern)
        (ms, spread), (plain_ms, plain_spread), (lib_ms, lib_spread) = (
            times[name], times[f"plain {name}"], times[f"{library} {source}"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/hopper/csrc/"
                      f"{CUDA_SOURCE.get(source, source)}.cu",
            "replaces": f"paddle_tpu/ops/pallas/{source}.py:{line}",
            "design": DESIGN,
            "launches": launches,
            "launches_per_step": launches / paths[label]["steps"],
            "max_abs_err": errs[name], "tolerance_rel": TOL["bfloat16"],
            "ms": ms, "ms_spread": spread,
            "plain_ms": plain_ms, "plain_ms_spread": plain_spread,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library_ms_spread": lib_spread,
        })
        print(f"{name} [{DESIGN}]: {ms:.3f} ms (spread {spread:.3f}), "
              f"bound {bound_ms:.4f} ms ({bound_by}), roofline share "
              f"{bound_ms / ms:.4f}, plain {plain_ms:.3f} ms (spread "
              f"{plain_spread:.3f}), library {lib_ms:.3f} ms (spread "
              f"{lib_spread:.3f})")
    print(json.dumps({"paths": {
        label: {k: v for k, v in p.items() if k != "launches"}
        for label, p in paths.items() if label != "layer_gpt"}}))
    print(json.dumps({"layer_gpt": {k: v for k, v in layer.items()
                                    if k != "launches"}}))
    print(json.dumps({"autotune": tuned}))
    print(json.dumps({"eager": eager}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"moe_gpt": {k: v for k, v in moe.items()
                                  if k != "launches"}}))
    print(json.dumps({"bert": bert}))
    print(json.dumps({"resnet50": resnet}))
    print(json.dumps({"model_fit": fit}))
    print(json.dumps({"jit": jit}))
    print(json.dumps({"eager_api": api}))
    print(json.dumps({"distributed": dd}))
    print(json.dumps({"tensor_parallel": tp}))
    print(json.dumps({"pipeline": pp}))
    print(json.dumps({"expert_parallel": ep}))
    print(json.dumps({"auto_parallel": ap}))
    print(json.dumps({"host_runtime": hr}))
    print(json.dumps({"breadth": br}))
    print(json.dumps({"tail": tail}))
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s", flush=True)
    if run.failures:
        print(f"chip_smoke: {len(run.failures)} check(s) failed:",
              file=sys.stderr)
        for what in run.failures:
            print(f"  {what[:300]}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
