#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --only-kernels  # phases 1-2: build + kernel checks

Phases, each of which exits non-zero on failure (nothing is caught):

1. Print the card's ``nvidia-smi --query-gpu=name,power.limit`` line and
   build every kernel of ``ray_tpu_torch/csrc`` for sm_90a (one nvcc per
   source, all started together), printing ptxas' registers, spills and
   warnings; a spill store in any kernel fails the run.
2. Each of the four kernels against its plain PyTorch version on the card,
   at the main paths' shapes, times by CUDA events (ragged decode: the
   profiler's device time of its two kernels, whose calls are too short
   for events around a host-bound loop):
   - first, untimed, the edge cases of the forward and the backward whose
     kernels work on 128-row tiles while callers need only T % 64 == 0:
     T in {64, 192, 2048} x head_dim {64, 128} x causal/full, batch 2;
   - flash forward on [1,32,T,128] bf16 (GQA, 8 kv heads) for T in {64,
     1024, 2048} causal plus a non-causal case, on [2,32,1024,128] causal
     (a coalesced prefill of two prompts, phase 12b) and on [4,32,2048,64]
     (training); bf16 O within atol = rtol = 2e-2 of the plain version
     (f32 math rounded to bf16), lse within 1e-3;
   - ragged paged decode with B=8, Hkv=8, G=4, Dh=128, P=64 over a 257-page
     pool with mixed positions, at pages_bound 1, 16 and 32, then at
     pages_bound 32 with every row full (pos 2047) and with every row at
     pos 0 (all splits but the first empty), timed, and at pages_bound 23
     (not a multiple of the pages per split) untimed; within 2e-2. One
     counted launch is two device kernels (split pass and merge pass), and
     the time covers both; each row prints the split count and the pages
     per split;
   - untimed, at GPT-2's shapes (phase 9): the forward on [1,12,1024,64]
     causal with as many kv heads as q heads, and ragged decode with
     Hkv=12, G=1, Dh=64, P=64 over a 16-page table;
   - timed, at the shapes of a tensor-parallel rank of Llama-3-8B at tp = 2
     (phase 11): the forward on [1,16,2048,128] causal over 4 kv heads, and
     ragged decode with Hkv=4, G=4, Dh=128, P=64 at pages_bound 32;
   - flash backward (dQ and dK/dV kernels) on [4,32,2048,64] causal
     (training), [1,32,2048,128] causal and [1,32,1024,64] full, timed,
     and on one- and two-tile sequences untimed; each gradient within
     atol = 2e-2 max|ref|, rtol = 2e-2 and a relative Frobenius error of
     1e-2 of the plain backward fed the same (o, lse) and dO, and the
     delta the dQ kernel writes within 1e-4 max|ref| of the plain f32
     delta.
3. Llama-3-8B at full width and depth (random init from a seed, bf16): one
   prefill at bucket 1024 and 4 teacher-forced ragged decode steps, kernels
   against plain versions, compared by cosine and max abs difference of the
   logits.
4. The serving path: ``LLMEngine.from_config`` (paged KV, page 64, 8 slots,
   max_len 2048) serves 8 concurrent greedy requests with prompts of 5 to
   1500 tokens and max_tokens 32. Launch counts are zeroed just before and
   read just after; both kernels must have run, the ragged one 32 times per
   decode step, and no backward kernel. Every path below counts all four
   kernels too.
5. Llama-3.2-1B (tied, random init, f32 params): loss and gradients of one
   [1, 2049] token row through the kernels, the plain versions and the
   plain versions in f32; per gradient group the kernels agree with the
   plain path (cosine) and are no farther from f32 than it.
6. The training path: ``make_train_step`` + ``adamw(1e-4, weight_decay=
   0.01)`` on Llama-3.2-1B, batch 4 x 2048, one warm-up and 10 timed steps
   through ``ray_tpu_torch.benchmarks.train_step.measure``. Losses finite
   and falling; launch counts zeroed just before the timed steps and read
   just after: 32 forward (16 layers, forward and remat recompute), 16
   dK/dV and 16 dQ launches a step, no ragged one.
7. Mixtral-8x7B at full width, 16 of its 32 layers (random init from a
   seed, bf16; the 32 layers' 93.4 GB do not fit the card): phase 3's
   check (one prefill at bucket 1024, 4 teacher-forced ragged decode
   steps, kernels against plain versions and both against f32, phase 3's
   bounds), with the MoE mlp in every layer. The two bf16 runs replay the
   f32 run's routing call by call, so that a near-tied router choice cannot
   flip between runs and compound with depth; per step, the share of
   (token, layer, choice) expert assignments on which the kernel and plain
   runs' own routing agrees.
8. Serving Mixtral, the slice's main path: phase 4's engine and 8 requests
   through ``LLMEngine.from_config(model_family="mixtral")`` at 16 layers;
   launch counts zeroed just before and read just after: flash = 16 x
   prefills, ragged = 16 x decode steps, no backward kernel.
9. The other families and the attention dispatcher on the card: GPT-2
   124M served (4 requests, max_len 1024: the kernels at head_dim 64,
   G = 1, learned positions); ViT-L/16 at batch 8 x 224² (T = 197), one
   forward and one ``loss_fn`` gradient in bf16 against f32 by cosine,
   with no flash launch (T = 197 takes the dense path); and
   ``transformer.forward`` (Llama-3.2-1B) with ``attn_impl=None`` at
   T = 100 bf16 and T = 128 f32 (the dense path, no launch) and T = 128
   bf16 (the forward kernel, one launch a layer), each against the plain
   path within phase 3's bounds.
10. The engine's options, Llama-3-8B at full width and depth (bf16, random
   weights from a seed, built once). First the model functions under
   phase 3's bounds, each against the path it is held to and an f32 run:
   chunked prefill (write_kv_pages, gather_prefix_pages,
   prefill_with_prefix, activate_slot, then 2 ragged decode steps) against
   whole-prompt prefill, the slot decode_step against the ragged paged step,
   verify_step's K = 5 logits and written KV against 5 slot decode steps,
   and LoRA prefill and decode with a random adapter against the adapter
   merged into wq and wv. Then one LLMEngine a run (8 slots, max_len
   2048, page 64), launch counts zeroed just before its traffic and read
   just after:
   paged (phase 4's 8 prompts), slot and paged ``attn_impl="gather"`` (the
   same prompts; first tokens equal the paged run's), prefix cache +
   ``prefill_chunk=512`` (a 1024-token shared prefix with 4 suffixes, the
   first served to its first token before the rest, and a 1500-token
   prompt; hits, misses, tokens reused, chunks, continuation prefills and
   returned pages asserted exactly), ``speculative_k=4`` on the slot layout
   (one token repeated to 1000, whose drafts must be accepted, and 3
   random prompts), LoRA (no adapter, a zero adapter token-exact to it, a
   random one; unload refused while live) and guided decoding (a choice
   FSM and a regex FSM, greedy and at temperature 1, outputs allowed and
   ended by EOS). Flash forward = layers x prefill calls, ragged = layers x
   decode steps on the paged ragged runs and 0 elsewhere, no backward
   kernel.

11. Multi-GPU (ray_tpu_torch.parallel) on the one card. No multi-rank NCCL
   path can run here: NCCL refuses two ranks on one GPU.
   a. A world of one over NCCL: ``MeshSpec().build()`` on a real NCCL
      group; Llama-3.2-1B at phase 6's config takes 3 steps through the
      meshed ``make_train_step`` (dp = 1: every gradient is allreduced over
      the one-rank group) and 3 through the unmeshed step from the same
      params and batch. Losses and params must be equal bit for bit (the
      stated bound is 0: a one-rank allreduce copies, and both runs launch
      the same kernels on the same data); launches per step equal phase
      6's, and the collective calls per step (all on CUDA tensors) > 0.
   b. Two ranks sharing the card over gloo, Llama-3-8B at full width and
      depth, tp = 2. First the main process computes, from seed-0 weights,
      a 1000-token prefill and 2 teacher-forced ragged decode steps with
      the kernels (tp = 1) and with f32 compute, then frees them; each
      rank builds the same weights, keeps its tensor-parallel cut and runs
      the same steps, held to the tp = 1 rows by phase 3's bounds
      (``hold``; the allreduce sums in another order, so bf16 is not
      token-exact). Then ``LLMEngine.from_config(mesh=tp 2)``, paged, serves
      phase 4's 8 prompts on both ranks: both ranks emit the same tokens,
      32 ragged launches per decode step and 32 flash launches per prefill
      on each rank's pool of 4 kv heads, no backward launch. Its times are
      labelled "2 ranks sharing one H100 over gloo": they are no multi-GPU
      numbers.
   c. ``parallel.dryrun.dryrun_multichip(4)`` over gloo, 4 ranks on the
      card: the tiny gspmd Mixtral step (dp x ep x tp), the pp x sp step
      (GPipe, ring attention) and the tp = 4 decode, every program on CUDA
      tensors (gloo takes every collective ``parallel/`` calls on them).

12. PD disaggregation below Serve, on phase 10's Llama-3-8B (built once;
   phase 12 runs right after phase 10, before phase 11 needs the memory).
   It prints /dev/shm's size first: a transfer channel holds
   ``prefetch_depth`` pages of 8 MiB (16 MiB); with less free than one
   channel the phase fails, with less than eight it runs the transfers in
   waves that fit.
   a. Phase 4's 8 prompts: ``decoding.prefill`` at each bucket (the
      monolithic engine's call), ``PagedKVExporter`` (PDConfig's page 64,
      prefetch 2), ``BatchedKVPuller`` into ``KVPageStream``s, and
      ``LLMEngine(**_pd_engine_kwargs(...)).submit_prefilled(kv_stream=)``.
      The greedy tokens must equal those of a monolithic paged LLMEngine
      serving the same prompts token for token; the pages the decode
      engine adopted must equal the exported ones byte for byte (exact
      integer fingerprints of the pool pages read back at adoption,
      against the exported pages'); flash = 32 x 8 prefills and none in the
      decode engine, ragged = 32 x decode steps, no backward kernel; no
      segment of the port's prefix is left after teardown. Both engines
      take the two longest prompts first, with 128 new tokens (the rest
      32): while either is resident every decode step sweeps 32 pages, so
      each row meets the same ragged split shape in both runs whatever the
      arrival timing, which bf16 token-exactness needs.
   b. The 8 prompts from 8 threads into one ``PrefillCoalescer``
      (max_batch 4, PDConfig's window): each row's logits against the
      solo prefill of its prompt and an f32 run under phase 3's bounds,
      flash launches = 32 x the coalescer's batches, jobs = 8.

13. The port's runtime core on the card (``ray_tpu_torch.init``; after
   phase 12 has freed its model, before phase 11). Requests go to the
   engines while their schedulers are held (``hold_admission``), so a
   run's admission, and its bf16 tokens, do not depend on arrival timing.
   a. ``cluster_resources()["GPU"]`` equals the driver's device count; a
      ``num_gpus=1`` task sees ``CUDA_VISIBLE_DEVICES`` equal to its grant
      and one device, a CPU task no CUDA.
   b. A ``num_gpus=1`` task runs the flash forward at [1,32,1024,128]
      causal and ragged decode at phase 2's case on seeded inputs and
      returns the CUDA outputs (back on the driver's card through the
      object store, bf16) and its own launch counts (exactly one each);
      the driver holds them to the plain versions on the same inputs at
      phase 2's tolerances and prints whether the worker had to run nvcc.
   c. A ``num_gpus=1`` actor runs phase 4's ``serve()`` twice: weight
      fingerprints and tokens equal phase 4's, launches layers x prefills
      and layers x steps, no backward.
   d. While that actor lives, a second ``num_gpus=1`` actor cannot start
      (``GetTimeoutError``); it starts after ``kill(first)``.
   e. ``init()`` s, a GPU worker's boot and its first torch import with a
      CUDA context, a no-op GPU task's round trip, put/get GB/s of a 256
      MiB CPU and CUDA tensor (three rounds), the actor's prefill and
      decode-step ms beside phase 4's.
   The session's shm segments are ``/dev/shm/rtpt_<session>*``, never
   ``rtpu_<session>*``; after ``shutdown()`` no worker process and no
   segment of the session under either prefix is left.

14. Llama-3-8B over HTTP from a Serve replica (a new runtime session,
   after phase 13, before phase 11). ``serve.start(http_port=0)`` and
   ``serve.run(build_openai_app(LLMConfig(...)), route_prefix="/llm")``:
   Llama-3-8B at full width, bf16, seed 0, phase 4's engine options, and
   ``ray_actor_options={"num_gpus": 1}``. The deployment's class is a
   subclass of the server's, defined here, whose probes read the token ids,
   launch counts, weight fingerprints and start-up times in the replica.
   a. The seconds from ``serve.run`` to HEALTHY and to the replica's first
      passed health probe, split into the replica process's start, its
      imports, its CUDA context and the model build; the replica's weights
      equal phase 4's.
   b. 8 byte-tokenized prompts of phase 4's lengths, one at a time, as
      ``POST /llm/v1/completions`` (greedy, 16 tokens): token ids (read in
      the replica), text and token counts equal an in-process
      ``LLMEngine`` serving each prompt alone on phase 10's weights.
   c. The same 8 prompts at once plus one SSE stream: each completes with
      the OpenAI shape and at most 16 tokens (agreement with 14b is
      reported: batch composition changes bf16 results); then the stream
      alone, whose chunks join to 14b's text of its prompt and whose ids
      equal 14b's.
   d. Launches in the replica over 14b and 14c: flash forward 32 x its
      prefills, ragged decode 32 x its decode steps, no backward.
   e. Host-clock times: the lone stream's time to its first chunk, each
      request's latency, the wave's tokens/s, the replica's prefill and
      decode-step ms beside phase 4's and 13c's.
   f. After ``serve.shutdown()`` and ``shutdown()`` no ``rtpt_routes_*``
      or ``rtpt_chan_*`` segment made during the phase, and no segment of
      the session, is left.

15. Llama-3-8B disaggregated over HTTP (a new runtime session, after
   phase 14, before phase 11): ``RAY_TPU_TORCH_WORKER_PLATFORM=cuda`` (and
   span sampling at every request) in the environment before ``init``, so
   that replicas without a GPU grant see the card, restored after.
   ``serve.run(build_pd_openai_app(LLMConfig(...)), route_prefix="/pd")``
   with phase 14's config and ``PDConfig()``: one prefill, one decode and
   one proxy replica, the classes swapped for probing subclasses defined
   here.
   a. Each pool's seconds to HEALTHY and to its first passed probe; the
      composition is the reference's (no GPU grant, one replica a pool);
      both replicas' weights equal phase 10's; the proxy holds no CUDA
      context.
   b. Phase 14's 8 prompts one at a time as ``POST /pd`` (greedy, 32
      tokens): the ids read in the decode replica equal an in-process
      ``LLMEngine`` on ``_pd_engine_kwargs`` serving each prompt alone
      (with, per prompt, how far ``prefill_batch`` at B = 1 and
      ``decoding.prefill`` are apart); 16 tokens, 0 < ttft_s <=
      total_time_s.
   c. The 8 at once plus an SSE stream (the proxy's reply shapes), the
      stream alone (its chunks join to 15b's text), then a client dropped
      after its first chunk of a 256-token request: the decode pool's
      slots and pages come back, no pull and no prefill ticket is pending,
      and the engine counted the abort.
   d. One sampled request's trace holds serve:request, proxy:route,
      pd:prefill, pd:kv_send, pd:kv_transfer, pd:admission and pd:decode
      across >= 3 processes; its pd_proxy row holds both TTFT halves.
   e. Launches over 15b-15d: the prefill replica flash = 32 x its prefill
      forwards and nothing else, the decode replica ragged = 32 x its
      decode steps and nothing else (no prefill), the proxy none.
   f. Host-clock times: the TTFT halves (``usage.ttft_s``, the recorder's
      ``decode_first_token``), latencies, the wave's tokens/s, the plane's
      pages and GB/s (pull to last page, read in the decode replica),
      beside phase 14's.
   g. After ``serve.shutdown()`` and ``shutdown()`` no ``rtpt_routes_*``
      or ``rtpt_chan_*`` segment made during the phase, and none of the
      session, is left.

16. Llama-3-8B batch inference over Data, and Data onto the card (a new
   runtime session, after phase 15, before phase 11):
   ``RAY_TPU_TORCH_WORKER_PLATFORM=cuda`` before ``init``, so that the
   processor's engine actor, which asks for no GPU, sees the card, and a
   store large enough for 16b's blocks; both restored after.
   a. ``build_llm_processor`` with phase 14's config (Llama-3-8B at full
      width, bf16, seed 0, phase 4's engine options), ``concurrency=1``,
      greedy with 16 tokens and the byte EOS; its actor class swapped for
      a probing subclass defined here. The actor's weights equal phase
      4's. 1: phase 14's 8 prompts at ``batch_size=1``: the ids read in
      the actor and the text equal in-process serving of each prompt
      alone. 2: a 64-row JSONL of byte-text prompts (lengths drawn from
      phase 4's mix) through ``read_json`` → ``map`` → the processor at
      ``batch_size=16`` → ``map`` → ``write_json``, read back: 64 rows, the
      input columns intact, each row's text the decode of ids the actor
      generated; how many rows equal an in-process engine fed the same
      batches is reported, not held (bf16 ids move with batch
      composition). 3: the actor's time to ready, rows/s and generated
      tokens/s; launches in the actor: flash forward 32 x its prefills,
      ragged 32 x its decode steps, no backward, and none in the driver.
   b. 2,048 uint8 rows of [224, 224, 3] (0.3 GB, numpy seed) through
      ``from_numpy`` in 4 blocks of 256; a ``map_batches`` stage of a
      callable class with ``num_gpus=1`` and ``concurrency=1`` normalizes
      each batch on the card and in numpy in its worker: one device
      visible, within 1e-6. Then ``iter_device_batches(device="cuda",
      prefetch=2)`` gives the batches on the driver's card, byte-exact to
      the host batches; GB/s and the consumer's wait per batch, beside a
      plain synchronous copy of the same batches.
   After ``shutdown()`` no segment of the session is left.

17. Train and Tune (a new runtime session, after phase 16, before phase
   11): ``RAY_TPU_TORCH_WORKER_PLATFORM=cuda`` before ``init`` (17c's and
   17d's workers hold half a GPU, which binds no card) and an 8 GiB store;
   both restored after. Launch counts are read in the workers and come
   back through ``session.report``; the driver launches no kernel while a
   ``fit()`` runs. Each sub-phase prints its time.
   a. Llama-3.2-1B (phase 6's config and optimizer) through
      ``TorchTrainer`` with one GPU worker, 4 steps at batch 4 x 2048 on
      token rows from a numpy seed, through ``get_dataset_shard("train")
      .iter_batches(batch_size=4)``: the worker's losses equal an
      in-process run of the same steps on the same rows bit for bit (the
      in-process run goes first and is freed before ``fit()``), its
      launches are phase 6's formula, ``Result.metrics`` holds the last
      loss; ``fit()``'s time and the worker's start-up split.
   b. GPT-2 124M, 4 steps at batch 8 x 1024 (step k's rows from numpy seed
      k), a checkpoint of params and AdamW state every 2 steps,
      ``FailureConfig(max_failures=1)``, ``CheckpointConfig(num_to_keep=
      1)``: the first attempt SIGKILLs its own worker in step 3, the second
      restores step 2's checkpoint; steps 3-4 equal an uninterrupted
      in-process run bit for bit, the attempts are errored then finished,
      the result's checkpoint is step 4's, and it is the one committed
      checkpoint left: retention deleted step 2's. No storage retry.
   c. Two workers with half the card each, ``ZeroShardedOptimizer`` over
      the host ring, 2 steps of GPT-2 on the halves of 17b's batches: f32
      AdamW uncompressed, then int8 AdamW with int8 gradients, held as
      tests/test_zero.py holds them to an unsharded in-process baseline
      stepping with the mean gradient (ranks equal, params within rtol
      1e-4 / atol 1e-6 and loss within rtol 1e-4 for f32, loss within rtol
      0.1 for int8, the opt-state gauge under 0.62 x the baseline's).
   d. ``Tuner`` over a ``TorchTrainer`` (one worker with half the card), a
      grid of two rates run at once, 2 steps: two results without error,
      each first loss equal to 17b's first step bit for bit, the best
      result the lower last loss, each worker's launches phase 6's formula.
   After ``shutdown()`` no segment of the session is left.

18. Device objects and compiled DAGs (a new runtime session, after phase
   17, before phase 11): ``RAY_TPU_TORCH_WORKER_PLATFORM=cuda`` before
   ``init`` (the actors hold GPU shares under 1) and a 4 GiB store; both
   restored after. Launch counts are zeroed just before each path and read
   just after, in the actors and the driver.
   a. A producer actor (``num_gpus=0.5``) builds Llama-3-8B (phase 10's
      weights, from the seed); its ``@method(tensor_transport="device")
      prefill`` returns the KV (2 x 64 MiB bf16) and f32 logits of one
      1024-token prompt through the flash forward. The result object the
      driver's store holds is under 64 KiB (markers only); a self-call
      sees the producer's own storage and its greedy token equals
      in-process prefill's; a consumer actor (``num_gpus=0.5``, another
      process) gets CUDA tensors byte-equal to the producer's (sha256 of
      the raw bytes in each process); once every ref is gone the
      producer's registry is empty and its ``memory_allocated()`` back
      within 1 MiB, within 15 s; flash launches 32 in the producer, none in
      the consumer or the driver. Prints the export's ms and GB/s and the
      consumer's get ms.
   b. ``InputNode -> Engine.generate -> Post.ids``, the engine a
      ``num_gpus=1`` actor holding an ``LLMEngine`` (paged, phase 4's
      options, greedy, 16 tokens), ``Post`` a CPU actor, compiled with 64
      KiB channels: on the channel plane (a fallback fails), phase 4's 8
      prompts one after the other and then 8 in flight token-exact to an
      in-process engine serving each prompt alone; flash = 32 x prefills
      and ragged = 32 x decode steps in the engine actor, none in the
      driver; ``list_compiled_dags()`` shows the DAG; teardown leaves no
      ``rtpt_chan_*`` segment.
   c. A chain of 4 actors sharing the card (``num_gpus=0.25``), each
      ``x + 1`` on a bf16 CUDA tensor of 16 KiB and of 16 MiB: every step
      equals ``x + 4`` exactly; the compiled step's median over 25 steps
      beside the same chain through ``.remote()``, and the 16 MiB
      payload's GB/s.
   After ``shutdown()`` no segment of the session is left.

19. Multi-host (a new runtime session, after phase 18, before phase 11):
   ``RAY_TPU_TORCH_WORKER_PLATFORM=cuda`` and a 4 GiB store, a head with
   ``num_gpus=1`` and follower hosts started by ``Cluster.add_host``: real
   node-agent processes with their own shm namespaces, joined over TCP.
   On one machine every host's GPU is the one H100: the single-card
   stand-in for separate machines, as phase 17c's two half-GPU workers
   stand in for two cards. host-1 (``num_gpus=1``) keeps the file store
   and serves it through the C++ object server; host-2 keeps the arena
   and the Python server.
   a. A ``num_gpus=1`` task pinned to host-1 builds Llama-3-8B (phase 10's
      weights, from the seed), prefills 18a's prompt and serves phase 4's
      prompts through an ``LLMEngine`` with phase 14's options; the
      driver's ``get`` pulls the KV and logits (CUDA tensors) from host-1's
      store into host-0's and onto its card. The token and the sha256 of
      the KV and logits equal in-process prefill's, the ids in-process
      serving's; flash = 32 x (1 + prefills) and ragged = 32 x decode
      steps in host-1's worker, none in the driver; the result's
      locations are host-1 before the get and both hosts after. Prints
      the pull's bytes, ms and GB/s, split into the transfer and the
      write into the driver's store.
   b. A 256 MiB bf16 CUDA tensor put on host-1 (its object address
      ``native:...``) and one put on host-2, each pulled by the driver:
      bytes sha256-equal to the maker's; prints each
      plane's pull GB/s and its transfer / store-write split.
   c. host-2 is removed; a ``num_gpus=1, max_retries=1`` prefill with a
      soft affinity to host-1 is running there when ``remove_host``
      SIGKILLs host-1 (its agent and workers). The node-leave event names
      host-1's lost GPU, ``list_nodes`` shows it dead, the retry runs on
      host-0's GPU with the in-process token, and ``get`` of a put object
      only host-1 held raises ObjectLostError. Prints the time to
      detection and to the retried result.
   After ``shutdown()`` no segment of the session (host-1's namespace
   included) is left, and the card's free memory is back within 1 GiB of
   its value before the phase.
20. Runtime envs and the autoscaler (after phase 19, before phase 11), with
   phase 19's env. A tiny local package is written to a temp directory and
   installed offline: ``runtime_env={"pip": ["--no-index",
   "--no-build-isolation", <dir>], "env_vars": {...}}``.
   a. A session whose head has one GPU: a ``num_gpus=1`` actor in that env
      boots through the worker_boot shim under a venv the head's
      runtime-env agent builds (``--system-site-packages`` and the .pth
      bridge give it the machine's CUDA torch), imports the package, sees
      the env var and the card, and runs ``follower_serve``'s body:
      Llama-3-8B from the seed, token, KV and logits bytes and the ids of
      the last 4 of phase 4's prompts equal in-process serving's, flash
      and ragged launched in its
      worker only. A second actor of the same spec boots from the cache
      (same prefix, no rebuild); a plain task does not see the package.
      Prints the venv's build time, the cached boot and the first token.
   b. A session whose head has no GPU and a monitor process
      (``python -m ray_tpu_torch._private.monitor``, provider ``local``,
      node type ``gpu`` = {CPU: 2, GPU: 1}, at most one node, idle timeout
      3 s, drain 1 s): the same pending actor makes the monitor launch a
      follower host (``as-gpu-*``), whose own runtime-env agent builds the
      env (a venv base of its own); the actor serves there as in 20a.
      After the actor is killed the node idles, drains and is terminated
      within the idle timeout plus a few passes; the instance table and
      the transitions counter show REQUESTED to TERMINATED; no process or
      segment of the host is left and the card's memory is back. Prints
      demand to create_node, to the join, to the actor ready and to the
      first token, and idle to terminated.
   c. A session whose head has no GPU and an in-process ``Autoscaler``
      over ``GceGpuNodeProvider(RestGceGpuApi(transport=...))`` with
      ``gpu_vm_node_type("a3-highgpu-1g", cpus=2, max_nodes=1)``. The
      transport is a fake of Compute v1's instances and zone operations
      (``FakeCompute`` below): its insert runs the request's
      ``startup-script`` unchanged under bash in a process group of its
      own, ``python`` on PATH the running interpreter; its delete SIGKILLs
      that group. A pending ``num_gpus=1`` actor lands on ``<vm>-w0``, the
      host the script's node agent joins as, and runs the flash forward on
      [1,32,1024,128] causal bf16: one launch counted in the actor, none
      in the driver, within phase 2's bounds of the plain version. After
      the kill the VM drains and the reconciler deletes it; no process of
      it and, after shutdown, no segment of the session is left. Prints
      the REST calls in order and demand to insert, to the join and to the
      result, and the kill to the delete.
21. The ops plane (after phase 20, before phase 11), every process started
   as a user starts it, in a fresh ``TMPDIR``: the port's CLI, a job, the
   dashboard. chip_smoke's own launch counts are zeroed before the phase
   and must still be 0 after it.
   a. ``python -m ray_tpu_torch.scripts.cli start --head --num-gpus 1
      --dashboard --dashboard-port 0`` as a subprocess; the session dir,
      the address and the dashboard's URL are read from its output;
      ``status`` and ``list nodes`` through the CLI show ``GPU: 1``.
   b. ``submit --no-wait`` of a script written to the temp dir (called by
      absolute path with this interpreter) whose driver joins the session
      from ``RAY_TPU_TORCH_ADDRESS`` and deploys phase 14's app
      (Llama-3-8B at full width, 32 layers, bf16, seed 0, phase 14's
      engine options, ``num_gpus=1``, the probing subclass), then sends
      phase 14's 8 prompts one at a time over HTTP: the ids read in the
      replica and the texts equal phase 14's in-process serving, the
      replica's weights phase 10's.
   c. While the app is up, the dashboard: ``/api/jobs`` (the job
      RUNNING), ``/api/serve`` (the replica healthy), ``/api/requests``
      (the 8 requests), ``/metrics`` (``ray_tpu_llm_decode_step_seconds``
      counting at least the replica's decode steps), ``/api/profile`` of
      the replica's worker during a wave of the 8 prompts at once (a
      non-empty profile), ``/api/timeline`` (a chrome trace), and the
      CLI's ``events``, ``trace list`` and ``summary``; each answer's time.
   d. A second job that blocks, stopped with ``job stop``: STOPPED, its
      process group gone. The first job is released: it reads the
      replica's counts (flash 32 x prefills, ragged 32 x decode steps, no
      backward) and its own (none, and no CUDA context: its driver sees
      no card), deletes the app and ends SUCCEEDED; ``job logs`` holds
      its JSON lines; the card's free memory is back within 1 GiB; after
      SIGINT the head has exited 0 and no segment or worker of the
      session is left.
   e. ``microbenchmark --min-seconds 0.25``, ``python -m
      ray_tpu_torch.scripts.llm_bench`` (on the card: d_model 1024, 8
      layers, bf16, paged; both serving kernels launched, no backward)
      and ``serve_bench``; every record printed; their artifacts under
      the phase's temp root and no JSON file of the checkout changed.
22. RLlib and the C++ worker (after phase 21, before phase 11), in a fresh
   session (16 CPUs, 2 pre-started workers); the runners are CPU actors,
   the learners on the card by default. chip_smoke's launch counts are
   zeroed before 22a and 22b and must be 0 after each (``rl_ppo``,
   ``rl_dqn``: RLlib reaches none of the four kernels).
   a. PPO on CartPole-v1 (tests/test_rllib.py's config: 2 runners x 8
      envs, fragment 64, lr 1e-3, minibatch 256, 4 epochs, seed 0), 12
      iterations: the learner's params on the card, the mean return's
      last > first + 15, total_loss finite. Prints each runner's seconds
      to ready, each iteration's seconds split into sample and learn, and
      the update's CUDA-event mean and median. Then one PPO update from
      the trained params and Adam state on a fresh 256-row minibatch, on
      the card and on the CPU: the worst leaf's max |card - cpu| over its
      max |cpu| within 1e-5.
   b. DQN on CartPole-v1 (tests/test_rllib_dqn.py's config), at most 40
      iterations: online and target params on the card, best mean return
      >= 60, updates made; prints iterations to the threshold and
      updates/s.
   c. 22a's PPO saved and restored into a fresh PPO on the card: equal
      params and equal greedy actions on 1,024 seeded observations.
   d. The port's C++ worker built by g++ from ``csrc/cpp_worker.cc`` and
      joined to the session: ``add``, ``concat`` and ``vec_sum`` answered.

23. RLlib's model-free algorithms (after phase 22, before phase 11), in a
   fresh session (16 CPUs, 2 pre-started workers); runners are CPU
   actors, the learners on the card by default. chip_smoke's launch
   counts are zeroed before each part and must be 0 after it
   (``rl_impala``, ``rl_appo``, ``rl_sac``, ``rl_bc``, ``rl_marwil``,
   ``rl_cql``, ``rl_iql``: RLlib reaches none of the four kernels).
   a. IMPALA on CartPole-v1 (tests/test_rllib_impala.py's config: 2
      streaming runners x 8 envs, fragment 48, lr 3e-3, seed 0), 16
      iterations: the learner on the card, the max of the last 4 mean
      returns > 40; then one runner killed and the next two iterations
      consume batches with 2 healthy runners again; then one V-trace
      update from the trained params and Adam state on one streamed batch
      on the card and on the CPU, within 1e-5 relative (worst leaf).
   b. APPO (tests/test_rllib_appo_sac.py's config, clip 0.3), 16
      iterations: > 40, the target's leaves in storage of their own, kl
      finite.
   c. SAC on Pendulum-v1 (2 runners x 4 envs, fragment 25, 128 updates of
      128 rows an iteration after 600 warm-up steps), at most 70
      iterations, stopping once the max of the last 4 mean returns passes
      -800: params and target twins on the card; one update from the
      trained state with fixed Gaussian draws on the card and on the CPU
      within 1e-5; saved and restored into a fresh SAC on the card: equal
      params and equal ``compute_single_action`` on 1,024 observations.
   d. BC from ``ray_tpu_torch.data.from_items`` (2,000 expert rows, lr
      1e-2, at most 8 iterations): accuracy >= 0.9 and 2,000 samples
      trained. MARWIL on the mixed CartPole dataset (8,000 rows, beta 1,
      lr 3e-3) from the JAX package's seed-0 init
      (tests/data/marwil_init_seed0.npz): evaluation return > 150 after 12
      iterations; the same run from the port's own seed-0 init is
      reported, not gated.
   e. CQL and IQL on the Pendulum dataset (40 scripted episodes, 1,000
      updates of 256 rows an iteration), each in a half-GPU task started
      with the phase and running beside a-d, evaluated from the 4th
      iteration on, each stopping at its first evaluation over -800
      within 12 iterations; ``cql_penalty`` and ``v_mean`` finite; the
      launch counts read in each worker.
   Each part prints each iteration's seconds (split into sample and learn
   where runners sample), each update's CUDA-event median and mean,
   updates/s and iterations to the bar; runners' seconds to ready.
24. DreamerV3 (after phase 23, before phase 11), in a fresh session (16
   CPUs, 2 pre-started workers); the runners CPU actors, the learner on
   the card by default. chip_smoke's launch counts are zeroed before each
   part and must be 0 after it (``rl_dreamerv3``: no kernel of the four).
   a. From the port's seed-0 init drawn on the CPU, one world-model update
      and one dream update on the card and on the CPU, on the same
      CartPole batch (16 random-action windows of 32 steps) and the same
      Gumbel draws (drawn on the CPU): every leaf, the slow critic, the
      return EMA and the features within 1e-4 absolute, and every sampled
      index (posterior latents, imagined actions and latents) equal.
   b. tests/test_rllib_dreamer.py's config (CartPole-v1, 2 runners x 4
      envs, fragment 64, 512 warm-up steps, 8 update pairs an iteration,
      seed 0), 40 iterations: params, slow critic and return EMA on the
      card; the max of the last 10 mean returns > 60 and the last
      ``wm_loss`` < 2.0. Prints the return curve, each iteration's seconds
      split into sample and learn, the world-model and dream updates'
      CUDA-event medians and means, and the runners' seconds to ready.

The line before last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
ATOL = RTOL = 2e-2         # bf16 outputs vs plain f32 math rounded to bf16
LSE_TOL = 1e-3
# flash backward, each of dq/dk/dv vs the plain f32 math rounded to bf16:
# elementwise within atol = BWD_TOL * max|ref| and rtol = BWD_TOL (P and dS
# are rounded to bf16 before the second products), and the relative
# Frobenius error within BWD_FRO_TOL
BWD_TOL = 2e-2
BWD_FRO_TOL = 1e-2
# delta = rowsum(dO * O) from the dQ kernel vs the plain f32 sum: the same
# f32 products summed in another order
DELTA_TOL = 1e-4
# model level, per step: kernels vs plain versions (both bf16), and the
# kernels' distance to an f32 run no worse than F32_ERR_RATIO x the plain
# versions' (bf16 rounding differences grow through 32 random layers)
LOGIT_COS_MIN = 0.995
GRAD_COS_MIN = 0.99        # phase 5: per gradient group, kernels vs plain
LOGIT_MAX_ABS = 0.6
F32_ERR_RATIO = 2.0
SEED = 0
# phase 7-8: Mixtral-8x7B's depth cut to fit one 80 GB card in bf16 (46.96 GB
# of weights at 16 layers; 93.4 GB at the published 32)
MIXTRAL_LAYERS = 16
EDGE_CASES = [(T, D, causal) for T in (64, 192, 2048) for D in (64, 128)
              for causal in (True, False)]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def zero(kernels) -> None:
    for k in kernels:
        k.launches = 0


def counts(kernels) -> dict:
    return {k.symbol: k.launches for k in kernels}


def cosine(torch, a, b) -> float:
    return torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, key: str) -> tuple[float, dict]:
    """Mean device time one call of fn spends in the kernels whose name
    contains `key`, from torch.profiler: the kernels' own time, without the
    gaps a host-bound stream of calls leaves between them (which CUDA
    events around the loop would count). Also that time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name: dict = {}
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and key in e.name):
                name = e.name[e.name.index(key):].split("(")[0]
                by_name[name] = (by_name.get(name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3 / iters)
        if by_name:
            return sum(by_name.values()), by_name
    # the profiler traced no kernel of `key` (seen once on the card's
    # machine): CUDA events around each call, started on an idle device,
    # which adds the host's gaps between the call's own launches
    print(f"device_ms: the profiler saw no device time in kernels named "
          f"*{key}*; timing each call by CUDA events", flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters, {"cuda_events_per_call": total / iters}


def ptxas_summary(logs: dict) -> list[dict]:
    """Registers and spill stores of every compiled entry, from nvcc's
    ``-Xptxas -v`` output."""
    import re

    rows, entry = [], None
    for lib, log in sorted(logs.items()):
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = {"library": lib, "entry": m.group(1)}
                rows.append(entry)
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and entry is not None:
                entry["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                entry["registers"] = int(m.group(1))
    for r in rows:
        r.setdefault("spill_stores", 0)
    return rows


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


# ------------------------------------------------------------------ phase 2

def check_flash(torch, gen, T: int, causal: bool, timed: bool,
                D: int = 128, B: int = 1, H: int = 32, Hkv: int = 8) -> dict:
    from ray_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    # [B, T, H, D] activations seen heads-major, exactly as ops.attention
    # hands them to the kernel on the prefill path
    q = torch.randn((B, T, H, D), generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    k = torch.randn((B, T, Hkv, D), generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    v = torch.randn((B, T, Hkv, D), generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    scale = D ** -0.5
    o, lse = fa._fwd_call(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_forward_plain(
        q.float(), k.float(), v.float(), causal=causal, scale=scale)
    o_ref = o_ref.to(torch.bfloat16).float()
    err = (o.float() - o_ref).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    if not torch.isfinite(o.float()).all():
        fail(f"flash T={T} causal={causal}: non-finite output")
    if not torch.allclose(o.float(), o_ref, atol=ATOL, rtol=RTOL):
        fail(f"flash T={T} causal={causal}: max abs err {err}")
    if lse_err > LSE_TOL:
        fail(f"flash T={T} causal={causal}: lse err {lse_err}")
    pairs = T * (T + 1) / 2 if causal else T * T
    flops = 4.0 * B * H * D * pairs
    nbytes = 2.0 * (2 * B * H * T * D + 2 * B * Hkv * T * D) + 4.0 * B * H * T
    bms, by = bound_ms(nbytes, flops)
    heads = "" if (H, Hkv) == (32, 8) else f" H={H} Hkv={Hkv}"
    row = {"case": f"flash B={B} T={T} D={D} causal={causal}{heads}",
           "shape": [B, H, T, D],
           "kv_heads": Hkv, "max_abs_err": err, "lse_max_abs_err": lse_err,
           "tolerance": ATOL, "lse_tolerance": LSE_TOL, "bound_ms": bms,
           "bound_by": by}
    if timed:
        kr = k.repeat_interleave(H // Hkv, dim=1).contiguous()
        vr = v.repeat_interleave(H // Hkv, dim=1).contiguous()
        qc = q.contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["ms"] = cuda_ms(torch, lambda: fa._fwd_call(
            q, k, v, causal=causal, scale=scale), 20)
        row["plain_ms"] = cuda_ms(torch, lambda: fa.flash_attention_forward_plain(
            q, k, v, causal=causal, scale=scale), 5)
        # yardstick only: one PyTorch call for the same function
        row["library_ms"] = cuda_ms(torch, lambda: sdpa(
            qc, kr, vr, is_causal=causal, scale=scale), 20)
    return row


def check_flash_bwd(torch, gen, B: int, T: int, D: int, causal: bool,
                    timed: bool) -> dict:
    """dQ and dK/dV kernels against the plain backward (f32 math rounded to
    bf16), both fed the forward kernel's (o, lse) and the same dO; and the
    delta the dQ kernel writes against the plain f32 delta."""
    from ray_tpu_torch.ops import flash_attention as fa

    H, Hkv = 32, 8
    dev = torch.device("cuda")

    def act(heads):  # [B, T, heads, D] seen heads-major, as in training
        return torch.randn((B, T, heads, D), generator=gen, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)

    q, k, v, do = act(H), act(Hkv), act(Hkv), act(H)
    scale = D ** -0.5
    o, lse = fa._fwd_call(q, k, v, causal=causal, scale=scale)
    grads = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                        scale=scale)
    torch.cuda.synchronize()
    refs = fa.flash_attention_backward_plain(
        q.float(), k.float(), v.float(), o, lse, do.float(), causal=causal,
        scale=scale)
    case = f"flash_bwd B={B} T={T} D={D} causal={causal}"
    row = {"case": case, "shape": [B, H, T, D], "kv_heads": Hkv,
           "atol_rel_max": BWD_TOL, "rtol": BWD_TOL, "fro_tol": BWD_FRO_TOL}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        got, ref = got.float(), ref.to(torch.bfloat16).float()
        atol = BWD_TOL * ref.abs().max().item()
        err = (got - ref).abs().max().item()
        fro = ((got - ref).norm() / ref.norm()).item()
        row[f"{name}_max_abs_err"], row[f"{name}_rel_fro_err"] = err, fro
        if not torch.isfinite(got).all():
            fail(f"{case}: non-finite {name}")
        if not torch.allclose(got, ref, atol=atol, rtol=BWD_TOL) \
                or fro > BWD_FRO_TOL:
            fail(f"{case}: {name} max abs err {err} (atol {atol}), "
                 f"relative Frobenius err {fro}")
    del refs
    kw = {"causal": causal, "scale": scale}
    # the delta the dQ kernel writes (the backward above kept it internal)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    fa._dq_launch(q, k, v, do, o, lse, delta, dq, **kw)
    torch.cuda.synchronize()
    delta_ref = fa.backward_delta(o, do)
    err = (delta - delta_ref).abs().max().item()
    row["delta_max_abs_err"] = err
    row["delta_atol"] = DELTA_TOL * delta_ref.abs().max().item()
    if not torch.isfinite(delta).all() or err > row["delta_atol"]:
        fail(f"{case}: delta max abs err {err} (atol {row['delta_atol']})")
    pairs = T * (T + 1) / 2 if causal else T * T
    qo_bytes = 2.0 * B * H * T * D    # one bf16 [B,H,T,D] tensor
    kv_bytes = 2.0 * B * Hkv * T * D  # one bf16 [B,Hkv,T,D] tensor
    stat_bytes = 4.0 * B * H * T      # one f32 [B,H,T] lse or delta
    # dK/dV reads q, k, v, dO, lse, delta and writes dK, dV; dQ reads q, k,
    # v, dO, O, lse and writes dQ and delta, whose 2*D FLOPs a row it adds
    row["dkv_bound_ms"], row["dkv_bound_by"] = bound_ms(
        2 * qo_bytes + 4 * kv_bytes + 2 * stat_bytes,
        8.0 * D * pairs * B * H)
    row["dq_bound_ms"], row["dq_bound_by"] = bound_ms(
        4 * qo_bytes + 2 * kv_bytes + 2 * stat_bytes,
        6.0 * D * pairs * B * H + 2.0 * D * B * H * T)
    if timed:
        row["dq_ms"] = cuda_ms(torch, lambda: fa._dq_launch(
            q, k, v, do, o, lse, delta, dq, **kw), 20)
        row["dkv_ms"] = cuda_ms(torch, lambda: fa._dkv_launch(
            q, k, v, do, lse, delta, dk, dv, **kw), 20)
        row["bwd_ms"] = cuda_ms(torch, lambda: fa.flash_attention_backward(
            q, k, v, o, lse, do, **kw), 20)  # both kernels
        row["plain_ms"] = cuda_ms(
            torch, lambda: fa.flash_attention_backward_plain(
                q, k, v, o, lse, do, **kw), 3, warmup=1)
        # yardstick only: autograd through one PyTorch call, backward timed
        qc, dc = q.contiguous().requires_grad_(), do.contiguous()
        kr, vr = (x.repeat_interleave(H // Hkv, dim=1).contiguous()
                  .requires_grad_() for x in (k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qc, kr, vr, is_causal=causal, scale=scale)
        row["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            out, (qc, kr, vr), dc, retain_graph=True), 20)
    return row


def ragged_inputs(torch, gen, Dh: int = 128, P: int = 64, N: int = 257,
                  Hkv: int = 8, G: int = 4):
    B = 8
    dev = torch.device("cuda")
    q = torch.randn((B, Hkv, G, Dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kp = torch.randn((N, P, Hkv, Dh), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn((N, P, Hkv, Dh), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    # each row owns (N-1)/B distinct pages out of 1..N-1, as the engine grants
    nb = (N - 1) // B
    perm = torch.randperm(N - 1, generator=gen, device=dev) + 1
    tbl = perm.reshape(B, nb).to(torch.int32)
    # mixed positions: first key, page end, page start, a full row, ...
    S = nb * P
    pos = torch.tensor([0, P - 1, P, S - 1, S // 2, S // 4, 2 * P + 2,
                        (3 * S) // 4], dtype=torch.int32, device=dev)
    return q, kp, vp, tbl, pos


def check_ragged(torch, inputs, nb: int, timed: bool, pos=None,
                 label: str = "") -> dict:
    """The ragged kernels (split and merge pass, one counted launch) against
    the plain version; `pos` replaces the inputs' mixed positions."""
    from ray_tpu_torch.ops import ragged_paged_attention as ra

    q, kp, vp, tbl_full, mixed = inputs
    pos = mixed if pos is None else pos
    B, Hkv, G, Dh = q.shape
    P = kp.shape[1]
    tbl = tbl_full[:, :nb]  # strided view, as the engine slices it
    scale = Dh ** -0.5
    name = f"ragged P={P} pages_bound={nb}{label}"
    out = ra.ragged_decode_attention(q, kp, vp, tbl, pos, scale=scale)
    torch.cuda.synchronize()
    ref = ra.ragged_decode_attention_reference(q, kp, vp, tbl, pos,
                                               scale=scale).float()
    err = (out.float() - ref).abs().max().item()
    if not torch.isfinite(out.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(out.float(), ref, atol=ATOL, rtol=RTOL):
        fail(f"{name}: max abs err {err}")
    S, pps = ra.ragged_splits(B, Hkv, nb, ra._sm_count(q.device.index))
    live = torch.minimum(pos.long() + 1, torch.full_like(pos.long(), nb * P))
    keys = int(live.sum().item())
    flops = 4.0 * Dh * G * Hkv * keys
    nbytes = (2.0 * 2 * keys * Hkv * Dh + 2 * 2.0 * q.numel()
              + 4.0 * (B * nb + B))
    bms, by = bound_ms(nbytes, flops)
    row = {"case": name, "shape": [B, Hkv, G, Dh], "page_size": P,
           "pool_pages": kp.shape[0], "live_keys": keys, "splits": S,
           "pages_per_split": pps, "max_abs_err": err, "tolerance": ATOL,
           "bound_ms": bms, "bound_by": by}
    if timed:
        def call():
            return ra.ragged_decode_attention(q, kp, vp, tbl, pos, scale=scale)

        # device time of the split and merge kernels of one call, and the
        # time a call takes in a back-to-back stream (host included)
        row["ms"], row["ms_by_kernel"] = device_ms(torch, call, 50,
                                                   "ragged_")
        row["call_ms"] = cuda_ms(torch, call, 50)
        row["plain_ms"] = cuda_ms(torch, lambda: ra.ragged_decode_attention(
            q, kp, vp, tbl, pos, scale=scale, impl="reference"), 5)
        row["library_ms"] = None  # no single PyTorch call does paged decode
    return row


# ------------------------------------------------------------------ phase 3

def logit_row(torch, what: str, k, p, t) -> dict:
    """Logits `k` (the path under test, bf16) against `p` (the path it is
    held to, bf16), each against `t` (f32 compute): cosine, max abs
    difference and relative distances to f32. Fails on a non-finite
    value."""
    k, p, t = k.float(), p.float(), t.float()
    if not all(torch.isfinite(x).all() for x in (k, p, t)):
        fail(f"{what}: non-finite logits")
    return {"cosine": torch.nn.functional.cosine_similarity(
                k.flatten(), p.flatten(), dim=0).item(),
            "max_abs_diff": (k - p).abs().max().item(),
            "kernel_rel_err_vs_f32": ((k - t).norm() / t.norm()).item(),
            "plain_rel_err_vs_f32": ((p - t).norm() / t.norm()).item()}


def hold(what: str, row: dict) -> None:
    """Phase 3's bounds: cosine >= LOGIT_COS_MIN, max abs difference <=
    LOGIT_MAX_ABS, and the tested path no farther from f32 than
    F32_ERR_RATIO x the other path (+ 1e-3)."""
    if row["cosine"] < LOGIT_COS_MIN or row["max_abs_diff"] > LOGIT_MAX_ABS \
            or row["kernel_rel_err_vs_f32"] > \
            F32_ERR_RATIO * row["plain_rel_err_vs_f32"] + 1e-3:
        fail(f"{what}: {row}")


class RoutingReplay:
    """Record and replay of ``ops.topk_routing`` (the models call it
    through the ops package). While active, the run named ``run`` gets, call
    by call, the routing the ``source`` run made in the same call; the
    source run records its own. With random weights the router's top-k is
    decided by small margins, so a choice that flipped between two runs
    would change that token's mlp outright and, through attention, every
    later token in the deeper layers: the model check would measure that
    drift, not the kernels. Each call also keeps the run's own, unforced
    choices ([N, E]: which experts kept the row) for the agreement
    statistic."""

    def __init__(self, torch, source: str = "f32"):
        from ray_tpu_torch import ops

        self.torch, self.ops, self.real = torch, ops, ops.topk_routing
        self.source, self.run = source, None
        self.recorded: list = []  # the source run's RoutingInfo, by call
        self.kept: dict = {}      # run -> its own [N, E] choices, by call

    def __enter__(self):
        def replayed(router_logits, *, num_experts, k, capacity_factor=1.25):
            own = self.real(router_logits, num_experts=num_experts, k=k,
                            capacity_factor=capacity_factor)
            kept = self.kept.setdefault(self.run, [])
            kept.append(own.dispatch.sum(-1) > 0)
            if self.run == self.source:
                self.recorded.append(own)
                return own
            forced = self.recorded[len(kept) - 1]
            if forced.dispatch.shape != own.dispatch.shape:
                fail(f"routing replay: call {len(kept) - 1} of run "
                     f"{self.run} routes {tuple(own.dispatch.shape)}, the "
                     f"{self.source} run {tuple(forced.dispatch.shape)}")
            return forced

        self.ops.topk_routing = replayed
        return self

    def __exit__(self, *exc):
        self.ops.topk_routing = self.real

    def agreement(self, a: str, b: str, calls: slice, rows: slice) -> float:
        """Share of run a's kept (row, expert) assignments in `calls` that
        run b's own routing also made."""
        same = total = 0
        for x, y in zip(self.kept[a][calls], self.kept[b][calls]):
            x, y = x[rows], y[rows]
            same += int((x & y).sum())
            total += int(x.sum())
        return same / total


def check_model(torch, cfg, label: str) -> dict:
    """Three runs of `cfg` on the same random weights and tokens: the
    plain versions with f32 compute, the kernels (bf16) and the plain
    versions (bf16), held to the f32 run as the yardstick. For a MoE config
    the bf16 runs replay the f32 run's routing (``RoutingReplay``), and
    each row also reports the share of expert assignments on which the
    kernel and plain runs' own routing agree, over the real rows (the
    prompt's tokens; the one live decode row) and over all rows the layers
    routed (the bucket's padding; the 7 idle slots)."""
    import contextlib
    import dataclasses

    import numpy as np

    from ray_tpu_torch.benchmarks.device_profile import busy_share
    from ray_tpu_torch.models import decoding, transformer
    from ray_tpu_torch.models import decoding_paged as dp

    dev = torch.device("cuda")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = transformer.init(gen, cfg, dev, dtype=cfg.dtype)
    n, bucket, P, max_len = 1000, 1024, 64, 2048
    rng = np.random.default_rng(SEED)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :n] = rng.integers(0, cfg.vocab_size, size=n)
    tokens = torch.as_tensor(padded, device=dev)
    # the f32 run first: under replay it routes for the other two
    runs = {"f32": (cfg32, "reference"), "kernel": (cfg, None),
            "plain": (cfg, "reference")}
    routing = RoutingReplay(torch) if cfg.moe is not None else None
    logits, kvs, states, rows = {}, {}, {}, []

    def compare(what, real_rows):
        row = {"step": what, **logit_row(
            torch, f"model {what}",
            *(logits[x] for x in ("kernel", "plain", "f32")))}
        if routing is not None:  # this step's calls, one a layer
            calls = slice(len(rows) * cfg.n_layers,
                          (len(rows) + 1) * cfg.n_layers)
            row["routing_agree"] = routing.agreement("kernel", "plain", calls,
                                                     real_rows)
            row["routing_agree_all_rows"] = routing.agreement(
                "kernel", "plain", calls, slice(None))
            if not rows:  # prefill: by layer, one call each
                row["routing_agree_by_layer"] = [
                    routing.agreement("kernel", "plain", slice(i, i + 1),
                                      real_rows)
                    for i in range(cfg.n_layers)]
        hold(f"model {what}", row)
        return row

    with routing if routing is not None else contextlib.nullcontext():
        for name, (c, impl) in runs.items():
            if routing is not None:
                routing.run = name
            logits[name], kvs[name] = decoding.prefill(params, tokens, n, c,
                                                       attn_impl=impl)
        rows.append(compare("prefill", slice(0, n)))
        first = int(torch.argmax(logits["f32"]))
        pages = np.arange(1, max_len // P + 1, dtype=np.int32)
        for name, (c, impl) in runs.items():
            states[name] = dp.init_paged_state(c, 8, max_len,
                                               8 * (max_len // P) + 1, P, dev)
            dp.insert_sequence_paged(states[name], 0, kvs.pop(name), n, first,
                                     pages, c)
        for step in range(4):
            pos = n + step
            bound = 1 << (pos // P).bit_length()  # pow2 >= live pages
            for name, (c, impl) in runs.items():
                if routing is not None:
                    routing.run = name
                states[name], lg = dp.decode_step_paged_ragged(
                    params, states[name], c, bound,
                    impl=impl)
                logits[name] = lg[0]
            rows.append(compare(f"decode {step}", slice(0, 1)))
            nxt = torch.argmax(logits["f32"]).int().reshape(1).expand(8)
            for name in runs:  # teacher-forced from the f32 run
                decoding.commit_tokens(states[name], nxt)
    del routing
    # host wall time of one kernel-path decode step (batch of 8 rows, one
    # live; its own routing, as served) against the device time of its
    # kernels
    busy = busy_share(lambda: dp.decode_step_paged_ragged(
        params, states["kernel"], cfg, 1 << ((n + 4) // P).bit_length()))
    return {"model": label, "prompt": n, "bucket": bucket,
            "cos_min": LOGIT_COS_MIN, "max_abs_bound": LOGIT_MAX_ABS,
            "f32_err_ratio": F32_ERR_RATIO,
            "routing": "replayed from the f32 run" if cfg.moe else None,
            "steps": rows, "decode_step_profile": busy}


# ------------------------------------------------------------------ phase 4

SERVE_LENGTHS = [5, 64, 65, 300, 700, 1000, 1300, 1500]


def hold_admission(eng):
    """Until the returned event is set, the engine's scheduler waits at the
    top of its next pass: requests submitted meanwhile are all seen by one
    pass, so the run depends on their order only, not on when the
    submitting thread got the CPU (a bf16 row's logits depend on the
    batch it decodes in)."""
    import threading

    gate = threading.Event()
    sync = eng._sync_pass

    def gated():
        gate.wait()
        return sync()

    eng._sync_pass = gated
    return gate


def weight_fingerprints(torch, params) -> dict:
    """Exact fingerprints of a few weight leaves: their 16-bit words times
    fixed int64 weights, summed modulo 2**64 (equal bytes, equal values)."""
    def fp(t):
        x = t.contiguous().view(torch.int16).flatten().to(torch.int64)
        w = torch.arange(1, x.numel() + 1, device=x.device,
                         dtype=torch.int64) * 0x5DEECE66D + 11
        return int((x * w).sum().item())

    layers = params["layers"]
    return {"embed[:1024]": fp(params["embed"][:1024]),
            "wq[0]": fp(layers["attn"]["wq"][0]),
            "wo[-1]": fp(layers["attn"]["wo"][-1]),
            "final_norm": fp(params["final_norm"]["w"])}


def serve(torch, kernels, family: str = "llama", model_id: str = "8b",
          model_kwargs: dict | None = None, lengths=SERVE_LENGTHS,
          max_len: int = 2048) -> dict:
    """Greedy requests with prompts of `lengths` tokens and max_tokens 32
    through ``LLMEngine.from_config`` of a model family (paged KV, page 64,
    8 slots), submitted while the scheduler is held (``hold_admission``).
    The counts of `kernels` are zeroed just before the requests and read
    just after: flash forward = layers x prefills, ragged = layers x decode
    steps, and no backward kernel. Returns the tokens and the fingerprints
    of a few weight leaves too."""
    import numpy as np

    from ray_tpu_torch.llm import (LLMConfig, LLMEngine, ModelLoadingConfig,
                                   SamplingParams)

    t0 = time.perf_counter()
    eng = LLMEngine.from_config(LLMConfig(
        model_family=family,
        model_loading_config=ModelLoadingConfig(model_id=model_id),
        model_kwargs=dict(model_kwargs or {}),
        engine_kwargs={"kv_layout": "paged", "page_size": 64, "max_slots": 8,
                       "max_len": max_len, "seed": SEED}))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    try:
        fingerprints = weight_fingerprints(torch, eng.params)
        rng = np.random.default_rng(SEED + 1)
        prompts = [rng.integers(0, eng.cfg.vocab_size, size=n).tolist()
                   for n in lengths]
        params = SamplingParams(max_tokens=32, temperature=0.0)
        gate = hold_admission(eng)
        zero(kernels)  # the main path starts here
        t0 = time.perf_counter()
        reqs = [eng.submit(p, params) for p in prompts]
        gate.set()
        outs = [list(r) for r in reqs]
        wall = time.perf_counter() - t0
        launches = counts(kernels)
        st = eng.stats()
        n_layers, vocab = eng.cfg.n_layers, eng.cfg.vocab_size
    finally:
        eng.shutdown()
    for n, out in zip(lengths, outs):
        if len(out) != 32 or not all(0 <= t < vocab for t in out):
            fail(f"request with prompt {n}: {len(out)} tokens, ids {out[:4]}")
    steps = st["decode_steps"]
    for sym, count in launches.items():
        served = sym in ("flash_attention_fwd_bf16",
                         "ragged_paged_attention_bf16")
        if served and count <= 0:
            fail(f"{sym} never launched on the main path")
        if not served and count:  # serving runs no backward
            fail(f"{sym} launched {count} times while serving")
    rag = launches["ragged_paged_attention_bf16"]
    if rag != n_layers * steps:
        fail(f"ragged launches {rag} != {n_layers} x {steps} decode steps")
    flash = launches["flash_attention_fwd_bf16"]
    if flash != n_layers * st["prefills"]:
        fail(f"flash launches {flash} != {n_layers} x {st['prefills']} "
             "prefills")
    return {"model": f"{family} {model_id} {model_kwargs or ''}".strip(),
            "n_layers": n_layers, "requests": len(outs),
            "prompt_lengths": list(lengths),
            "tokens_out": sum(len(o) for o in outs), "wall_s": wall,
            "engine_build_s": build_s,
            "prefill_ms_mean": 1e3 * st["prefill_seconds"] / st["prefills"],
            "decode_step_ms_mean": 1e3 * st["decode_seconds"] / steps,
            "decode_steps": steps, "decode_occupancy": st["decode_occupancy"],
            "tokens_per_s": sum(len(o) for o in outs) / wall,
            "launches": launches, "tokens": outs,
            "fingerprints": fingerprints}


# ------------------------------------------------------------------ phase 5

GRAD_GROUPS = {  # leaf paths of each gradient group compared in phase 5
    "wq": [("layers", "attn", "wq")],
    "wk": [("layers", "attn", "wk")],
    "wv": [("layers", "attn", "wv")],
    "wo": [("layers", "attn", "wo")],
    "mlp": [("layers", "mlp", n) for n in ("wi_gate", "wi_up", "wo")],
    "norms": [("layers", "norm1", "w"), ("layers", "norm2", "w"),
              ("final_norm", "w")],
    "embed": [("embed",)],
}


def train_config():
    from ray_tpu_torch.models import llama

    return llama.llama_config("1b", tie_embeddings=True, max_seq_len=2048)


def check_model_grads(torch, kernels) -> dict:
    """Llama-3.2-1B (random init from a seed, f32 params), loss and
    gradients on one [1, 2049] token row three ways: the kernels (bf16
    compute), the plain versions (bf16) and the plain versions with f32
    compute. Per gradient group: cosine(kernels, plain) >= GRAD_COS_MIN,
    and the kernels' relative distance to the f32 run at most F32_ERR_RATIO
    x the plain path's + 1e-3. The backward kernels must have run in the
    kernel run and in no other."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import transformer

    dev = torch.device("cuda")
    cfg = train_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = transformer.init(gen, cfg, dev)
    paths = sorted({p for ps in GRAD_GROUPS.values() for p in ps})

    def leaf(path):
        x = params
        for key in path:
            x = x[key]
        return x

    leaves = [leaf(p).requires_grad_() for p in paths]
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 2049)),
                             device=dev)
    runs = {"kernel": (cfg, None), "plain": (cfg, "reference"),
            "f32": (dataclasses.replace(cfg, dtype=torch.float32),
                    "reference")}
    loss, flat, launches = {}, {}, {}
    for name, (c, impl) in runs.items():
        zero(kernels)
        value = transformer.loss_fn(params, tokens, c, attn_impl=impl)
        grads = dict(zip(paths, torch.autograd.grad(value, leaves)))
        torch.cuda.synchronize()
        launches[name] = counts(kernels)
        loss[name] = value.item()
        flat[name] = {g: torch.cat([grads[p].float().flatten() for p in ps])
                      for g, ps in GRAD_GROUPS.items()}
        del grads
    for name, run_counts in launches.items():
        for k in kernels:
            want = cfg.n_layers if name == "kernel" else 0
            if k.symbol != "flash_attention_fwd_bf16" and \
                    run_counts[k.symbol] != want:
                fail(f"model grads, {name} run: {k.symbol} launched "
                     f"{run_counts[k.symbol]} times, expected {want}")
    rows = {}
    t = loss["f32"]
    for g in GRAD_GROUPS:
        k, p, f = (flat[x][g] for x in ("kernel", "plain", "f32"))
        if not all(torch.isfinite(x).all() for x in (k, p, f)):
            fail(f"model grads {g}: non-finite gradient")
        row = {"cosine": torch.nn.functional.cosine_similarity(
                   k, p, dim=0).item(),
               "kernel_norm": k.norm().item(),
               "kernel_rel_err_vs_f32": ((k - f).norm() / f.norm()).item(),
               "plain_rel_err_vs_f32": ((p - f).norm() / f.norm()).item()}
        rows[g] = row
        if row["kernel_norm"] == 0 or row["cosine"] < GRAD_COS_MIN \
                or row["kernel_rel_err_vs_f32"] > \
                F32_ERR_RATIO * row["plain_rel_err_vs_f32"] + 1e-3:
            fail(f"model grads {g}: {row}")
    loss_row = {"kernel": loss["kernel"], "plain": loss["plain"], "f32": t,
                "kernel_rel_err_vs_f32": abs(loss["kernel"] - t) / abs(t),
                "plain_rel_err_vs_f32": abs(loss["plain"] - t) / abs(t)}
    if not all(np.isfinite(v) for v in loss.values()) or \
            loss_row["kernel_rel_err_vs_f32"] > \
            F32_ERR_RATIO * loss_row["plain_rel_err_vs_f32"] + 1e-3:
        fail(f"model loss: {loss_row}")
    return {"model": "llama-3.2-1b random init, f32 params", "tokens": 2049,
            "cos_min": GRAD_COS_MIN, "f32_err_ratio": F32_ERR_RATIO,
            "loss": loss_row, "grads": rows, "launches": launches}


# ------------------------------------------------------------------ phase 6

def train(torch, kernels) -> dict:
    """The training path: make_train_step + adamw(1e-4, weight_decay=0.01)
    on Llama-3.2-1B, batch 4 x 2048, one warm-up step and 10 timed steps
    through benchmarks.train_step.measure. Launch counts are zeroed just
    before the timed steps and read just after."""
    import math

    from ray_tpu_torch.benchmarks.train_step import measure

    cfg = train_config()
    got = {}
    res = measure(cfg, batch=4, seq=2048, steps=10,
                  before_timed=lambda: zero(kernels),  # the main path starts
                  after_timed=lambda: got.update(counts(kernels)),
                  profile=True)
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"training losses not finite and falling: {losses}")
    L, steps = cfg.n_layers, res["steps"]
    # forward plus its recompute under remat, one dK/dV and one dQ per layer
    want = {"flash_attention_fwd_bf16": 2 * L * steps,
            "flash_attention_bwd_dkv_bf16": L * steps,
            "flash_attention_bwd_dq_bf16": L * steps,
            "ragged_paged_attention_bf16": 0}
    if got != want:
        fail(f"training launches {got}, expected {want}")
    res["launches"] = got
    res["config"] = {"model": "llama-3.2-1b (tied, random init)",
                     "n_layers": L, "d_model": cfg.d_model,
                     "vocab_size": cfg.vocab_size, "remat": cfg.remat,
                     "remat_policy": cfg.remat_policy}
    return res


# ------------------------------------------------------------------ phase 9

def check_vit(torch, kernels) -> dict:
    """ViT-L/16 at its published widths and depth, batch 8 x 224² (T =
    197, head_dim 64), random init from a seed with f32 params: forward
    logits and the gradient of every param from one ``loss_fn`` in bf16
    compute against f32 compute, by cosine (logits: LOGIT_COS_MIN, the
    whole gradient: GRAD_COS_MIN). T = 197 is no multiple of 64, so no
    flash kernel may launch."""
    import dataclasses

    from ray_tpu_torch.models import vit

    dev = torch.device("cuda")
    cfg = vit.vit_config("l16")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = vit.init(gen, cfg, dev)
    images = torch.randn((8, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (8,), generator=gen,
                           device=dev)

    def flat(tree):
        for v in tree.values():
            yield from (flat(v) if isinstance(v, dict) else [v])

    leaves = [x.requires_grad_() for x in flat(params)]
    zero(kernels)  # the ViT path starts here
    logits, grads = {}, {}
    for name, dt in (("bf16", cfg.dtype), ("f32", torch.float32)):
        c = dataclasses.replace(cfg, dtype=dt)
        with torch.no_grad():
            logits[name] = vit.forward(params, images, c)
        loss = vit.loss_fn(params, (images, labels), c)
        grads[name] = torch.cat([g.float().flatten() for g in
                                 torch.autograd.grad(loss, leaves)])
    torch.cuda.synchronize()
    launches = counts(kernels)
    row = {"model": "vit-l/16 random init, f32 params", "batch": 8,
           "tokens": cfg.n_patches + 1, "head_dim": cfg.head_dim,
           "logits_cosine": cosine(torch, logits["bf16"], logits["f32"]),
           "grad_cosine": cosine(torch, grads["bf16"], grads["f32"]),
           "grad_norm": grads["bf16"].norm().item(),
           "cos_min": LOGIT_COS_MIN, "grad_cos_min": GRAD_COS_MIN,
           "launches": launches}
    if not all(torch.isfinite(x).all() for x in (*logits.values(),
                                                  *grads.values())):
        fail(f"vit: non-finite logits or gradients: {row}")
    if row["logits_cosine"] < LOGIT_COS_MIN or row["grad_norm"] == 0 \
            or row["grad_cosine"] < GRAD_COS_MIN:
        fail(f"vit: bf16 against f32: {row}")
    if any(launches.values()):
        fail(f"vit at T = 197 launched a flash kernel: {launches}")
    return row


def check_dispatch(torch, kernels) -> dict:
    """``transformer.forward`` with ``attn_impl=None`` on the card where the
    kernels fit and where they do not (Llama-3.2-1B widths and depth, f32
    params): T = 100 in bf16 and T = 128 in f32 take the dense path and
    launch nothing; T = 128 in bf16 launches the forward kernel once a
    layer. Each against the plain path by phase 3's bounds on the logits
    (cosine, max abs difference)."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import transformer

    dev = torch.device("cuda")
    cfg = train_config()
    params = transformer.init(torch.Generator(device=dev).manual_seed(SEED),
                              cfg, dev)
    rng = np.random.default_rng(SEED)
    rows = []
    for T, dt, want in ((100, torch.bfloat16, 0), (128, torch.float32, 0),
                        (128, torch.bfloat16, cfg.n_layers)):
        c = dataclasses.replace(cfg, dtype=dt)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, T)),
                                 device=dev)
        zero(kernels)  # this case's path starts here
        with torch.no_grad():
            auto, _ = transformer.forward(params, tokens, c)
            torch.cuda.synchronize()
            launches = counts(kernels)
            plain, _ = transformer.forward(params, tokens, c,
                                           attn_impl="reference")
        row = {"T": T, "dtype": str(dt).replace("torch.", ""),
               "launches": launches, "cosine": cosine(torch, auto, plain),
               "max_abs_diff": (auto.float() - plain.float()).abs().max()
               .item()}
        rows.append(row)
        if not torch.isfinite(auto.float()).all():
            fail(f"dispatch {row}: non-finite logits")
        if launches != {k.symbol: (want if k.symbol ==
                                   "flash_attention_fwd_bf16" else 0)
                        for k in kernels}:
            fail(f"dispatch {row}: expected {want} forward launches")
        if row["cosine"] < LOGIT_COS_MIN or row["max_abs_diff"] > \
                LOGIT_MAX_ABS:
            fail(f"dispatch {row}: against the plain path")
    return {"model": "llama-3.2-1b (tied, random init), attn_impl=None",
            "cos_min": LOGIT_COS_MIN, "max_abs_bound": LOGIT_MAX_ABS,
            "cases": rows}


# ----------------------------------------------------------------- phase 10

ENGINE_RUNS = ("paged", "slot", "gather", "prefix_chunk", "speculative",
               "lora", "guided")
ENGINE_MAX_TOKENS = 32
SHARED_PREFIX = 1024           # 16 full pages of 64
SUFFIXES = [60, 150, 280, 400]
LONG_PROMPT = 1500
PREFILL_CHUNK = 512
SPEC_K = 4
LORA_RANK = 8
EOS_ID = 128001                # the guided runs' stop token
CHOICES = [[9906, 1917], [9642, 11, 1314], [2822, 13, 21, 8]]
REGEX = "(ok|no)[0-9]+"        # over single-byte token ids


def engine_model_checks(torch, cfg, params) -> list[dict]:
    """The model functions of the engine's options at Llama-3-8B's width
    and depth, each path under test against the path it is held to (both
    bf16) and against an f32 run, under phase 3's bounds (``hold``); decode
    steps are teacher-forced from the f32 run:

    - chunked prefill: a 384-token first chunk (the flash kernel, bucket
      512) written with write_kv_pages, its 6 pages back through
      gather_prefix_pages padded to 8 with scratch page 0 (filled with
      noise, as inactive rows leave it; prefix_len masks it), the 616-token
      rest by prefill_with_prefix (last logits), activate_slot and 2 ragged
      decode steps, against whole-prompt prefill + insert_sequence_paged
      and the same steps;
    - the slot decode_step against decode_step_paged_ragged on the same
      prompt (2 steps);
    - verify_step's K = 5 logits, and the K rows of K and V it writes,
      against 5 successive slot decode_steps on the same tokens;
    - LoRA prefill and 2 decode_steps with a random rank-8 adapter against
      the adapter merged densely into wq and wv (the f32 run: merged in
      f32)."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import decoding as dec
    from ray_tpu_torch.models import decoding_paged as dp

    dev = torch.device("cuda")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    P, S, n, head, K = 64, 2048, 1000, 384, SPEC_K + 1
    rng = np.random.default_rng(SEED + 10)
    toks = rng.integers(0, cfg.vocab_size, size=n).tolist()
    pages = np.arange(1, S // P + 1, dtype=np.int32)
    rows = []

    def tokens(t, bucket):
        x = np.zeros((1, bucket), np.int64)
        x[0, :len(t)] = t
        return torch.as_tensor(x, device=dev)

    def check(what, k, p, t):
        row = {"check": what, **logit_row(torch, what, k, p, t)}
        rows.append(row)
        hold(what, row)

    def paged(c):
        return dp.init_paged_state(c, 8, S, S // P + 1, P, dev)

    def slot(c):
        return dec.init_decode_state(c, 8, S, dev)

    def forced(states, logits32):
        nxt = torch.argmax(logits32).int().reshape(1).expand(8)
        for st in states:
            dec.commit_tokens(st, nxt)

    lg32, kv32 = dec.prefill(params, tokens(toks, 1024), n, cfg32,
                             attn_impl="reference")
    first = int(torch.argmax(lg32))
    lgw, kvw = dec.prefill(params, tokens(toks, 1024), n, cfg)
    st_c = paged(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    for pool in (st_c["kp"], st_c["vp"]):
        pool[:, 0] = torch.randn(pool[:, 0].shape, generator=gen, device=dev,
                                 dtype=pool.dtype)
    _, kv1 = dec.prefill(params, tokens(toks[:head], 512), head, cfg)
    dp.write_kv_pages(st_c, kv1, pages[:512 // P])
    ids = np.zeros((8,), np.int32)
    ids[:head // P] = pages[:head // P]
    k_pre, v_pre = dp.gather_prefix_pages(st_c["kp"], st_c["vp"], ids)
    lgc, kv2 = dp.prefill_with_prefix(params, tokens(toks[head:], 1024),
                                      k_pre, v_pre, head, n - head, cfg)
    dp.write_kv_pages(st_c, kv2, pages[head // P:])
    dp.activate_slot(st_c, 0, pages, n, first)
    del kv1, kv2, k_pre, v_pre
    check("prefill_with_prefix over gathered pages vs whole prefill", lgc,
          lgw, lg32)
    st32, st_w, st_s = paged(cfg32), paged(cfg), slot(cfg)
    dp.insert_sequence_paged(st32, 0, kv32, n, first, pages, cfg32)
    dp.insert_sequence_paged(st_w, 0, kvw, n, first, pages, cfg)
    dec.insert_sequence(st_s, 0, kvw, n, first, cfg)
    for step in range(2):
        bound = 1 << ((n + step) // P).bit_length()
        st32, l32 = dp.decode_step_paged_ragged(params, st32, cfg32, bound,
                                                impl="reference")
        st_w, lw = dp.decode_step_paged_ragged(params, st_w, cfg, bound)
        st_c, lc = dp.decode_step_paged_ragged(params, st_c, cfg, bound)
        st_s, ls = dec.decode_step(params, st_s, cfg)
        check(f"decode {step} after chunked prefill vs after whole prefill",
              lc[0], lw[0], l32[0])
        check(f"slot decode_step {step} vs decode_step_paged_ragged", ls[0],
              lw[0], l32[0])
        forced((st32, st_w, st_c, st_s), l32[0])
    del st32, st_w, st_c, st_s
    # verify_step: K inputs at once against K decode steps on the same tokens
    draft = np.zeros((8, K - 1), np.int32)
    draft[0] = rng.integers(0, cfg.vocab_size, size=K - 1)
    st_v, st_d, st_f = slot(cfg), slot(cfg), slot(cfg32)
    for st, kv, c in ((st_v, kvw, cfg), (st_d, kvw, cfg), (st_f, kv32, cfg32)):
        dec.insert_sequence(st, 0, kv, n, first, c)
    del kv32, kvw
    st_v, lv = dec.verify_step(params, st_v, draft, cfg, K)
    for j in range(K):
        st_d, ld = dec.decode_step(params, st_d, cfg)
        st_f, lf = dec.decode_step(params, st_f, cfg32)
        check(f"verify_step logits {j} vs slot decode_step {j}", lv[0, j],
              ld[0], lf[0])
        if j < K - 1:
            nxt = torch.full((8,), int(draft[0, j]), dtype=torch.int32,
                             device=dev)
            dec.commit_tokens(st_d, nxt)
            dec.commit_tokens(st_f, nxt)
    for name in ("k", "v"):  # the K rows each path wrote
        check(f"verify_step's written {name} rows vs the decode steps'",
              *(st[name][:, 0, n:n + K] for st in (st_v, st_d, st_f)))
    del st_v, st_d, st_f, lv
    # LoRA: a random adapter in the bank against it merged into wq and wv
    bank = dec.init_lora_bank(cfg, 1, LORA_RANK, dev)
    w = lora_adapter(torch, cfg, dev)
    for key, x in w.items():
        bank[key][:, 1] = x
    bank["scale"][1] = 1.0
    attn32, attn = {}, {}
    for key, a, b in (("wq", "A_q", "B_q"), ("wv", "A_v", "B_v")):
        base = params["layers"]["attn"][key]
        attn32[key] = base.float() + torch.einsum(
            "ler,lrhd->lehd", w[a].float(), w[b].float())
        attn[key] = attn32[key].to(base.dtype)

    def merged(new):
        layers = params["layers"]
        return {**params, "layers": {**layers,
                                     "attn": {**layers["attn"], **new}}}

    m_bf16, m_f32 = merged(attn), merged(attn32)
    lgl, kvl = dec.prefill(params, tokens(toks, 1024), n, cfg,
                           lora_bank=bank, lora_idx=1)
    lgm, kvm = dec.prefill(m_bf16, tokens(toks, 1024), n, cfg)
    lgf, kvf = dec.prefill(m_f32, tokens(toks, 1024), n, cfg32,
                           attn_impl="reference")
    check("LoRA prefill vs the adapter merged into wq, wv", lgl, lgm, lgf)
    first = int(torch.argmax(lgf))
    st_l, st_m, st_f = slot(cfg), slot(cfg), slot(cfg32)
    for st, kv, c in ((st_l, kvl, cfg), (st_m, kvm, cfg), (st_f, kvf, cfg32)):
        dec.insert_sequence(st, 0, kv, n, first, c)
    del kvl, kvm, kvf
    slot_lora = torch.zeros((8,), dtype=torch.int64, device=dev)
    slot_lora[0] = 1
    for step in range(2):
        st_l, ll = dec.decode_step(params, st_l, cfg, bank, slot_lora)
        st_m, lm = dec.decode_step(m_bf16, st_m, cfg)
        st_f, lf = dec.decode_step(m_f32, st_f, cfg32)
        check(f"LoRA decode_step {step} vs the merged adapter", ll[0], lm[0],
              lf[0])
        forced((st_l, st_m, st_f), lf[0])
    return rows


def lora_adapter(torch, cfg, device) -> dict:
    """A rank-8 adapter of normal(0, 0.02) factors from a seed, layer-
    stacked as load_lora takes it, in cfg.dtype on `device`."""
    L, E, H, Hkv, Dh = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                        cfg.head_dim)
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    shapes = {"A_q": (L, E, LORA_RANK), "B_q": (L, LORA_RANK, H, Dh),
              "A_v": (L, E, LORA_RANK), "B_v": (L, LORA_RANK, Hkv, Dh)}
    return {k: (torch.randn(s, generator=g) * 0.02).to(device, cfg.dtype)
            for k, s in shapes.items()}


def engine_run(torch, kernels, cfg, params, name: str, options: dict, drive,
               prepare=None) -> dict:
    """One LLMEngine (8 slots, max_len 2048, page 64) on the shared params:
    `prepare(eng)` first, then the launch counts are zeroed, `drive(eng)`
    serves the run's traffic and returns (outputs, extra), and the counts
    are read. Every output must be a non-empty list of valid ids."""
    from ray_tpu_torch.llm import LLMEngine

    eng = LLMEngine(cfg, params, max_slots=8, max_len=2048, page_size=64,
                    seed=SEED, **options)
    try:
        if prepare is not None:
            prepare(eng)
        torch.cuda.synchronize()
        zero(kernels)  # this run's path starts here
        t0 = time.perf_counter()
        outs, extra = drive(eng)
        wall = time.perf_counter() - t0
        launches = counts(kernels)
        st = eng.stats()
    finally:
        eng.shutdown()
    for i, out in enumerate(outs):
        if not out or not all(0 <= t < cfg.vocab_size for t in out):
            fail(f"engine {name}: request {i} gave {out[:8]}")
    spec = st.get("speculative", {})
    steps = st["decode_steps"] + spec.get("steps", 0)
    prefills = st["prefills"] + st["prefix_prefills"]
    tokens = sum(len(o) for o in outs)
    return {"run": name, "options": options, "requests": len(outs),
            "tokens_out": tokens, "wall_s": wall,
            "prefill_ms_mean": 1e3 * st["prefill_seconds"] / prefills,
            "step": "verify" if spec else "decode",
            "step_ms_mean": 1e3 * st["decode_seconds"] / steps,
            "tokens_per_s": tokens / wall, "launches": launches,
            "stats": st, "extra": extra, "outs": outs}


def serve_options(torch, kernels, card: str, cfg, params) -> dict:
    """Phase 10: Llama-3-8B at full width and depth (bf16, random weights
    from a seed, built once by the caller), the model checks of
    ``engine_model_checks``,
    then one LLMEngine a run on those params (ENGINE_RUNS), each shut down
    before the next. Per run, the launch counts are zeroed just before its
    traffic and read just after, and must be exactly: flash forward =
    layers x decode.prefill calls (whole prompts and first chunks; the
    count of those calls is itself asserted), ragged = layers x decode
    steps on the paged ragged runs and 0 elsewhere, no backward kernel."""
    import re

    import numpy as np

    from ray_tpu_torch.llm import GuidedFSM, SamplingParams

    checks = engine_model_checks(torch, cfg, params)
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "engine_model_checks": checks}),
          flush=True)
    V, L = cfg.vocab_size, cfg.n_layers
    greedy = SamplingParams(max_tokens=ENGINE_MAX_TOKENS)
    runs = {}

    def prompts(lengths, seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, V, size=n).tolist() for n in lengths]

    def serve_all(ps, sp=greedy):
        def drive(eng):
            reqs = [eng.submit(p, sp) for p in ps]
            return [list(r) for r in reqs], {}
        return drive

    def run(name, options, drive, prepare=None, *, prefills, ragged,
            full=True):
        row = engine_run(torch, kernels, cfg, params, name, options, drive,
                         prepare)
        shown = row["outs"] if name == "guided" else [o[:8]
                                                      for o in row["outs"]]
        print(json.dumps({"card": card, "engine_run": {**row, "outs": shown}}),
              flush=True)
        st = row["stats"]
        want = {k.symbol: 0 for k in kernels}
        want["flash_attention_fwd_bf16"] = L * st["prefills"]
        want["ragged_paged_attention_bf16"] = \
            L * st["decode_steps"] if ragged else 0
        if row["launches"] != want or st["ragged_kernel"] != ragged:
            fail(f"engine {name}: launches {row['launches']}, expected "
                 f"{want} (ragged kernel {st['ragged_kernel']})")
        if st["prefills"] != prefills:
            fail(f"engine {name}: {st['prefills']} prefill calls, expected "
                 f"{prefills}")
        if full and any(len(o) != ENGINE_MAX_TOKENS for o in row["outs"]):
            fail(f"engine {name}: output lengths "
                 f"{[len(o) for o in row['outs']]}")
        runs[name] = row
        print(f"engine {name} on {card}: prefill {row['prefill_ms_mean']:.3f}"
              f" ms mean, {row['step']} step {row['step_ms_mean']:.3f} ms "
              f"mean, {row['tokens_per_s']:.1f} tokens/s", flush=True)
        return row

    lengths = prompts(SERVE_LENGTHS, SEED + 1)
    first = [o[0] for o in run("paged", {"kv_layout": "paged"},
                               serve_all(lengths), prefills=8,
                               ragged=True)["outs"]]
    for name, options in (("slot", {"kv_layout": "slot"}),
                          ("gather", {"kv_layout": "paged",
                                      "attn_impl": "gather"})):
        got = [o[0] for o in run(name, options, serve_all(lengths),
                                 prefills=8, ragged=False)["outs"]]
        if got != first:
            fail(f"engine {name}: first tokens {got} != the paged run's "
                 f"{first}")

    # prefix cache + chunked prefill
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(0, V, size=SHARED_PREFIX).tolist()
    pc = [shared + rng.integers(0, V, size=n).tolist() for n in SUFFIXES]
    pc.append(rng.integers(0, V, size=LONG_PROMPT).tolist())

    def drive_prefix(eng):
        it = iter(eng.submit(pc[0], greedy))
        head = [next(it)]  # its chunks registered the shared blocks
        reqs = [eng.submit(p, greedy) for p in pc[1:]]
        return [head + list(it)] + [list(r) for r in reqs], {}

    staged = [-(-len(p) // PREFILL_CHUNK) for p in (pc[0], pc[-1])]
    row = run("prefix_chunk", {"kv_layout": "paged",
                               "enable_prefix_cache": True,
                               "prefill_chunk": PREFILL_CHUNK},
              drive_prefix, prefills=2, ragged=True)
    st, cache = row["stats"], row["stats"]["prefix_cache"]
    got = {"hits": cache["hits"], "misses": cache["misses"],
           "tokens_reused": cache["tokens_reused"],
           "prefill_chunks_run": st["prefill_chunks_run"],
           "prefix_prefills": st["prefix_prefills"],
           "pages_back": st["free_pages"] + cache["reclaimable_pages"]}
    want = {"hits": 3, "misses": 2, "tokens_reused": 3 * SHARED_PREFIX,
            "prefill_chunks_run": sum(staged),
            "prefix_prefills": 3 + sum(staged) - 2,
            "pages_back": st["num_pages"] - 1}
    if got != want:
        fail(f"engine prefix_chunk: {got}, expected {want}")

    # speculative decoding on the slot layout. The repetitive prompt is one
    # token repeated: random weights continue neither a repeated 64-token
    # pattern nor their own greedy text, but after a constant context
    # their greedy output falls into a short cycle the drafts then predict
    sp_prompts = [[int(rng.integers(0, V))] * 1000] + prompts(
        [300, 700, 1300], SEED + 3)

    def drive_spec(eng):
        reqs = [eng.submit(p, greedy) for p in sp_prompts]
        outs = [list(r) for r in reqs]
        return outs, {"accepted_by_request": [r.accepted for r in reqs]}

    row = run("speculative", {"kv_layout": "slot", "speculative_k": SPEC_K},
              drive_spec, prefills=4, ragged=False)
    if row["extra"]["accepted_by_request"][0] <= 0:
        fail(f"engine speculative: no draft accepted on the repetitive row "
             f"({row['extra']}, {row['stats']['speculative']})")

    # LoRA: no adapter, a zero adapter and a random one in one batch
    rand = {k: v.float().cpu().numpy()
            for k, v in lora_adapter(torch, cfg, "cpu").items()}
    zeros = {k: np.zeros_like(v) for k, v in rand.items()}

    def prepare_lora(eng):
        eng.load_lora("zero", zeros)
        eng.load_lora("rand", rand)

    def drive_lora(eng):
        loaded = eng.list_loras()
        reqs = [eng.submit(lengths[3], greedy, lora=x)
                for x in (None, "zero", "rand")]
        try:
            eng.unload_lora("rand")
        except RuntimeError:
            refused = True
        else:
            refused = False
        outs = [list(r) for r in reqs]
        eng.unload_lora("rand")
        eng.unload_lora("zero")
        return outs, {"loaded": loaded, "unload_refused_while_live": refused,
                      "after_unload": eng.list_loras()}

    row = run("lora", {"kv_layout": "slot", "max_loras": 2,
                       "lora_rank": LORA_RANK}, drive_lora, prepare_lora,
              prefills=3, ragged=False)
    outs, extra = row["outs"], row["extra"]
    if outs[1] != outs[0] or extra != {
            "loaded": ["rand", "zero"], "unload_refused_while_live": True,
            "after_unload": []}:
        fail(f"engine lora: zero adapter {outs[1][:8]} vs none "
             f"{outs[0][:8]}; {extra}")

    # guided decoding on the paged layout, greedy and at temperature 1
    choice = GuidedFSM.from_choices(CHOICES, V, EOS_ID)
    regex = GuidedFSM.from_regex(REGEX, V, EOS_ID)
    g_prompts = prompts([40, 90, 200, 500], SEED + 5)
    kinds = ["choice", "regex", "free", "free"] * 2

    def drive_guided(eng):
        reqs = []
        for temp in (0.0, 1.0):
            for fsm, p in zip((choice, regex, None, None), g_prompts):
                reqs.append(eng.submit(p, SamplingParams(
                    max_tokens=ENGINE_MAX_TOKENS, temperature=temp,
                    stop_token_ids=(EOS_ID,) if fsm else (), guided=fsm)))
        return [list(r) for r in reqs], {"kinds": kinds}

    row = run("guided", {"kv_layout": "paged"}, drive_guided, prefills=8,
              ragged=True, full=False)
    for kind, out in zip(kinds, row["outs"]):
        ended = len(out) < ENGINE_MAX_TOKENS  # stopped on EOS
        ok = {"choice": ended and out in CHOICES,
              "regex": ended and re.fullmatch(
                  REGEX, "".join(chr(t) for t in out)) is not None,
              "free": len(out) == ENGINE_MAX_TOKENS}[kind]
        if not ok:
            fail(f"engine guided: a {kind} row gave {out}")
    return {name: row["launches"] for name, row in runs.items()}


# ----------------------------------------------------------------- phase 12

PD_LONG = 1300          # prompts at least this long sweep 32 pages a step
PD_LONG_TOKENS = 128    # their new tokens: they outlive the other rows
PD_WAIT_S = 120.0


def page_hash(torch, t, w):
    """Exact fingerprint of a page's bytes on the card: its int16 words
    times fixed random int64 weights, summed modulo 2**64 (order-free, so
    equal bytes give equal values)."""
    x = t.contiguous().view(torch.int16).flatten().to(torch.int64)
    return (x * w[:x.numel()]).sum()


def wait_for(pred, what: str, timeout_s: float = PD_WAIT_S) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            fail(f"timed out after {timeout_s} s waiting for {what}")
        time.sleep(0.002)


def plane_stages(torch, kv, page_size: int, depth: int) -> dict:
    """The transfer plane's stages for one prefilled bucket, one after the
    other on this thread (no sender, puller or engine thread competing),
    host clock in ms: device-to-host copy of K and V, slicing the pages
    contiguous, copying each message into a channel, reading each back
    with a clone, and copying the pages to the card."""
    from ray_tpu_torch.experimental.channel.mutable_shm import (
        create_mutable_channel)
    from ray_tpu_torch.llm import kv_transfer as kt

    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return out

    k, v = timed("d2h", lambda: (kv["k"].cpu(), kv["v"].cpu()))
    n = k.shape[1] // page_size
    kps, vps = timed("slice", lambda: kt._pages(k, v, 0, n, page_size))
    ch = create_mutable_channel(depth * (k.nbytes + v.nbytes) // n
                                + kt._WIRE_SLACK)
    try:
        ms["channel_write"] = ms["read_clone"] = 0.0
        pages = []
        for i in range(0, n, depth):
            t0 = time.perf_counter()
            ch.write_vectored(kt._pack_page_message(
                i, kps[i:i + depth], vps[i:i + depth]), timeout=0)
            t1 = time.perf_counter()
            view = ch.read_view(timeout=0)
            pages += kt._copy_pages(*kt._unpack_page_view(view))
            del view
            ch.ack_read()
            ms["channel_write"] += 1e3 * (t1 - t0)
            ms["read_clone"] += 1e3 * (time.perf_counter() - t1)
    finally:
        ch.close()
        ch.unlink()
    dev = kv["k"].device
    timed("h2d", lambda: [(kp.to(dev), vp.to(dev)) for _i, kp, vp in pages])
    nbytes = k.nbytes + v.nbytes
    return {"pages": n, "bytes": nbytes, "ms": ms,
            "gb_per_s": {name: nbytes / t / 1e6 for name, t in ms.items()}}


def pd_handoff(torch, kernels, card, cfg, params, prompts, max_tokens, ek,
               want) -> dict:
    """12a: prefill → export → batched pull → streamed admission, against
    the monolithic run's tokens `want`. Returns the run's numbers and the
    solo prefill logits (12b's reference)."""
    import glob
    import shutil

    from ray_tpu_torch._private.constants import SHM_CHANNEL_GLOB, SHM_DIR
    from ray_tpu_torch.llm import LLMEngine, PDConfig, SamplingParams
    from ray_tpu_torch.llm.engine import bucket_for
    from ray_tpu_torch.llm.kv_transfer import (BatchedKVPuller, KVPageStream,
                                               PagedKVExporter)
    from ray_tpu_torch.models import decoding
    from ray_tpu_torch.models import decoding_paged as dp

    dev = torch.device("cuda")
    pd = PDConfig()
    L, P = cfg.n_layers, ek["page_size"]
    page_bytes = 2 * L * P * cfg.kv_heads * cfg.head_dim * 2  # K + V, bf16
    chan_bytes = pd.prefetch_depth * page_bytes + 8192 + 64
    usage = shutil.disk_usage(SHM_DIR)
    print(json.dumps({"card": card, "dev_shm": {
        "total": usage.total, "used": usage.used, "free": usage.free,
        "channel_bytes": chan_bytes}}), flush=True)
    if usage.free < chan_bytes:
        fail(f"{SHM_DIR} has {usage.free} bytes free; one KV transfer "
             f"channel needs {chan_bytes} ({pd.prefetch_depth} pages of "
             f"{page_bytes} bytes + framing)")
    wave = int(min(len(prompts), usage.free // chan_bytes))
    # the long rows first, alone, active before the others arrive
    order = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))
    n_long = sum(len(p) >= PD_LONG for p in prompts)
    groups = [part[i:i + wave] for part in (order[:n_long], order[n_long:])
              for i in range(0, len(part), wave)]
    shm_before = set(glob.glob(SHM_CHANNEL_GLOB))
    w = torch.randint(-2 ** 62, 2 ** 62, (L * P * cfg.kv_heads * cfg.head_dim,),
                      dtype=torch.int64, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    adopted = []
    real_write = dp.write_kv_pages

    def write_and_hash(state, kv, pages):
        real_write(state, kv, pages)
        for pid in list(pages)[:kv["k"].shape[1] // P]:
            adopted.append(torch.stack([page_hash(torch, state[x][:, pid], w)
                                        for x in ("kp", "vp")]))
        return state

    dec = LLMEngine(cfg, params, **ek)
    exporter = PagedKVExporter(send_timeout_s=pd.transfer_timeout_s,
                               prefetch_pages=pd.prefetch_depth)
    puller = BatchedKVPuller()
    dp.write_kv_pages = write_and_hash
    try:
        torch.cuda.synchronize()
        zero(kernels)  # the PD path starts here
        t_start = time.perf_counter()
        kvs, firsts, solo, exported = [], [], [], []
        for p in prompts:
            bucket = bucket_for(len(p), ek["min_bucket"], ek["max_len"])
            toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
            toks[0, :len(p)] = torch.as_tensor(p, device=dev)
            logits, kv = decoding.prefill(params, toks, len(p), cfg)
            solo.append(logits)
            firsts.append(int(torch.argmax(logits)))
            kvs.append(kv)
            exported += [torch.stack([page_hash(torch, kv[x][:, i * P:(i + 1)
                                                             * P], w)
                                      for x in ("k", "v")])
                         for i in range(bucket // P)]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t_start
        prefill_launches = counts(kernels)
        reqs, export_ms, t_pull = {}, {}, {}
        plane_s, streamed = 0.0, [0, 0.0]
        for gi, group in enumerate(groups):
            t_group = time.time()
            st0 = dec.stats()  # the wave's export and transfer start here
            tickets = {}
            for i in group:
                t0 = time.perf_counter()
                tickets[i] = exporter.export(kvs[i]["k"], kvs[i]["v"],
                                             len(prompts[i]), firsts[i], P)
                export_ms[i] = 1e3 * (time.perf_counter() - t0)
            streams = {}
            for i in group:
                t = tickets[i]
                streams[i] = KVPageStream(t["n_pages"], t["page_size"])
                t_pull[i] = time.time()
                puller.pull(t, streams[i], timeout_s=pd.transfer_timeout_s)
                reqs[i] = dec.submit_prefilled(
                    length=t["length"], first_token=t["first_token"],
                    params=SamplingParams(max_tokens=max_tokens[i]),
                    kv_stream=streams[i])
            def landed():
                for i, s in streams.items():
                    if s.take_error() is not None:
                        fail(f"pd: transfer of prompt {len(prompts[i])}: "
                             f"{s.take_error()!r}")
                return all(s.finished_ts for s in streams.values())

            wait_for(landed, f"the pages of wave {gi}")
            plane_s += max(s.finished_ts for s in streams.values()) - t_group
            st1 = dec.stats()
            if st0["active"]:  # decode steps taken while it streamed
                streamed[0] += st1["decode_steps"] - st0["decode_steps"]
                streamed[1] += st1["decode_seconds"] - st0["decode_seconds"]
            wait_for(lambda: all(reqs[i].admitted_ts for i in group),
                     f"the rows of wave {gi} to activate")
            wait_for(lambda: exporter.pending() == 0,
                     f"wave {gi}'s channels to retire")
        st_idle = dec.stats()
        outs = [[firsts[i]] + list(reqs[i]) for i in range(len(prompts))]
        wall = time.perf_counter() - t_start
        launches = counts(kernels)
        st = dec.stats()
    finally:
        dp.write_kv_pages = real_write
        exporter.teardown()
        puller.teardown()
        dec.shutdown()
    stages = plane_stages(torch, kvs[order[0]], P, pd.prefetch_depth)
    del kvs
    wait_for(lambda: not set(glob.glob(SHM_CHANNEL_GLOB)) - shm_before,
             "the transfer segments to be unlinked", 10.0)
    if outs != want:
        bad = [i for i, (a, b) in enumerate(zip(outs, want)) if a != b]
        fail(f"pd: prompts {[len(prompts[i]) for i in bad]} decode "
             f"{[outs[i][:8] for i in bad]}, the monolithic engine "
             f"{[want[i][:8] for i in bad]}")
    adopted = sorted(tuple(h.tolist()) for h in adopted)
    exported = sorted(tuple(h.tolist()) for h in exported)
    if adopted != exported:
        fail(f"pd: the {len(adopted)} adopted pool pages differ from the "
             f"{len(exported)} exported pages")
    flash, ragged = "flash_attention_fwd_bf16", "ragged_paged_attention_bf16"
    want_launches = {k.symbol: 0 for k in kernels}
    want_launches[flash] = L * len(prompts)
    want_launches[ragged] = L * st["decode_steps"]
    if launches != want_launches or prefill_launches[flash] != launches[flash] \
            or st["prefills"] or not st["ragged_kernel"]:
        fail(f"pd: launches {launches} (after the prefills "
             f"{prefill_launches}), expected {want_launches} and no flash "
             f"launch in the decode engine ({st['prefills']} prefills)")
    n_pages = len(exported)
    idle_steps = st["decode_steps"] - st_idle["decode_steps"]
    row = {
        "prompt_lengths": [len(p) for p in prompts],
        "max_tokens": max_tokens, "waves": groups, "pages": n_pages,
        "page_bytes": page_bytes, "bytes": n_pages * page_bytes,
        "plane_gb_per_s": n_pages * page_bytes / plane_s / 1e9,
        "plane_s": plane_s, "prefill_s": prefill_s,
        "export_ms": [export_ms[i] for i in range(len(prompts))],
        "pull_adopt_ms": [1e3 * (reqs[i].admitted_ts - t_pull[i])
                          for i in range(len(prompts))],
        "decode_steps": st["decode_steps"],
        "decode_step_ms_streaming": (1e3 * streamed[1] / streamed[0]
                                     if streamed[0] else None),
        "decode_steps_streaming": streamed[0],
        "decode_step_ms_idle_stream": (
            1e3 * (st["decode_seconds"] - st_idle["decode_seconds"])
            / idle_steps if idle_steps else None),
        "decode_steps_idle_stream": idle_steps,
        "decode_step_ms_mean": 1e3 * st["decode_seconds"] / st["decode_steps"],
        "wall_s": wall, "tokens_out": sum(len(o) for o in outs),
        "plane_stages_longest_prompt": stages,
        "launches": launches, "tokens_exact": True,
        "pages_byte_exact": True, "shm_leaked": 0}
    return row, solo


def pd_coalesced(torch, kernels, card, cfg, params, prompts, ek,
                 solo) -> dict:
    """12b: the 8 prompts from 8 threads into one PrefillCoalescer; each
    row held to the solo prefill and an f32 run under phase 3's bounds."""
    import dataclasses
    import threading

    from ray_tpu_torch.llm import PDConfig
    from ray_tpu_torch.llm.pd import PrefillCoalescer
    from ray_tpu_torch.models import decoding

    dev = torch.device("cuda")
    pd = PDConfig()
    co = PrefillCoalescer(params, cfg, min_bucket=ek["min_bucket"],
                          max_len=ek["max_len"],
                          max_batch=pd.prefill_batch_max,
                          window_s=pd.prefill_batch_window_s)
    res: list = [None] * len(prompts)

    def run(i):
        try:
            res[i] = co.prefill(prompts[i])
        except BaseException as e:  # noqa: BLE001 — reported below
            res[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    torch.cuda.synchronize()
    zero(kernels)  # the coalesced prefill path starts here
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=PD_WAIT_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels)
    co.teardown()
    if any(t.is_alive() for t in threads):
        fail("pd coalescer: a prefill thread did not return")
    errors = [r for r in res if isinstance(r, BaseException)]
    if errors:
        fail(f"pd coalescer: {errors[0]!r}")
    flash = "flash_attention_fwd_bf16"
    want = {k.symbol: 0 for k in kernels}
    want[flash] = cfg.n_layers * co.batches
    if co.jobs != len(prompts) or launches != want:
        fail(f"pd coalescer: {co.jobs} jobs in {co.batches} batches, "
             f"launches {launches}, expected {want}")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    rows = []
    for i, p in enumerate(prompts):
        logits, _k, _v, bucket = res[i]
        toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
        toks[0, :len(p)] = torch.as_tensor(p, device=dev)
        f32, _ = decoding.prefill(params, toks, len(p), cfg32,
                                  attn_impl="reference")
        row = {"prompt": len(p), "bucket": bucket,
               **logit_row(torch, f"pd coalesced row {i}", logits, solo[i],
                           f32),
               "bit_identical_to_solo": bool(torch.equal(logits, solo[i])),
               "first_token_agrees": int(torch.argmax(logits))
               == int(torch.argmax(solo[i]))}
        hold(f"pd coalesced prefill row of prompt {len(p)} vs solo prefill",
             row)
        rows.append(row)
        del f32
    return {"batches": co.batches, "jobs": co.jobs,
            "max_batch": co.max_batch, "window_s": co.window_s,
            "wall_s": wall, "launches": launches, "rows": rows}


def serve_pd(torch, kernels, card: str, cfg, params) -> dict:
    """Phase 12 on phase 10's model: the monolithic reference run, 12a and
    12b. Returns each path's launch counts."""
    import numpy as np

    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.pd import _pd_engine_kwargs

    t_phase = time.perf_counter()
    ek = _pd_engine_kwargs(LLMConfig(engine_kwargs={
        "max_slots": 8, "max_len": 2048, "seed": SEED}))
    rng = np.random.default_rng(SEED + 1)  # phase 4's prompts
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in SERVE_LENGTHS]
    max_tokens = [PD_LONG_TOKENS if len(p) >= PD_LONG else 32
                  for p in prompts]
    order = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))
    mono = LLMEngine(cfg, params, **ek)
    try:
        torch.cuda.synchronize()
        zero(kernels)
        t0 = time.perf_counter()
        reqs = {i: mono.submit(prompts[i], SamplingParams(
            max_tokens=max_tokens[i])) for i in order}
        want = [list(reqs[i]) for i in range(len(prompts))]
        mono_wall = time.perf_counter() - t0
        mono_launches = counts(kernels)
        st = mono.stats()
    finally:
        mono.shutdown()
    expect = {k.symbol: 0 for k in kernels}
    expect["flash_attention_fwd_bf16"] = cfg.n_layers * st["prefills"]
    expect["ragged_paged_attention_bf16"] = cfg.n_layers * st["decode_steps"]
    if mono_launches != expect or [len(o) for o in want] != max_tokens:
        fail(f"pd monolithic run: launches {mono_launches}, expected "
             f"{expect}; lengths {[len(o) for o in want]}")
    handoff, solo = pd_handoff(torch, kernels, card, cfg, params, prompts,
                               max_tokens, ek, want)
    print(json.dumps({"card": card, "pd_handoff": handoff}), flush=True)
    print(f"pd handoff on {card}: {handoff['pages']} pages, "
          f"{handoff['bytes']} bytes, plane {handoff['plane_gb_per_s']:.3f} "
          f"GB/s; export {np.mean(handoff['export_ms']):.3f} ms and "
          f"pull/adopt {np.mean(handoff['pull_adopt_ms']):.3f} ms a request "
          f"(mean); decode step {handoff['decode_step_ms_streaming']} ms "
          f"while transfers stream, {handoff['decode_step_ms_idle_stream']} "
          f"ms after; monolithic decode step "
          f"{1e3 * st['decode_seconds'] / st['decode_steps']:.3f} ms; one "
          f"bucket's stages alone (ms): "
          f"{handoff['plane_stages_longest_prompt']['ms']}", flush=True)
    coalesced = pd_coalesced(torch, kernels, card, cfg, params, prompts, ek,
                             solo)
    print(json.dumps({"card": card, "pd_coalesced_prefill": coalesced}),
          flush=True)
    print(f"pd coalesced prefill on {card}: {coalesced['jobs']} prompts in "
          f"{coalesced['batches']} batches, "
          f"{sum(r['bit_identical_to_solo'] for r in coalesced['rows'])} "
          f"rows bit-identical to solo, "
          f"{sum(r['first_token_agrees'] for r in coalesced['rows'])} first "
          f"tokens agree; phase 12 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"pd_monolithic": mono_launches, "pd_handoff": handoff["launches"],
            "pd_coalesced_prefill": coalesced["launches"],
            "monolithic": {"wall_s": mono_wall, "stats": st}}


# ----------------------------------------------------------------- phase 13

RT_FLASH = dict(B=1, T=1024, D=128, H=32, Hkv=8)  # 13b's flash forward
RT_SEED = SEED + 13
RT_BYTES = 256 << 20    # 13e's put/get payload


def kernel_inputs(torch, seed: int):
    """13b's seeded inputs, made the same way on the worker and the driver:
    the flash forward at [1,32,1024,128] causal and phase 2's ragged case."""
    c = RT_FLASH
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    qkv = [torch.randn((c["B"], c["T"], h, c["D"]), generator=gen, device=dev,
                       dtype=torch.bfloat16).transpose(1, 2)
           for h in (c["H"], c["Hkv"], c["Hkv"])]
    return qkv, ragged_inputs(torch, gen)


def worker_kernels(seed: int, prepare=None) -> dict:
    """13b, in a num_gpus=1 task: both serving kernels on seeded inputs; the
    CUDA outputs go back through the object store with the worker's own
    launch counts, the GPUs it sees, and the kernels nvcc had to build in
    this process (none when it loads the driver's build)."""
    import os

    import torch

    if prepare is not None:
        prepare()
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ragged_paged_attention as ra

    built = _build.build_all([fa.KERNEL.source, ra.KERNEL.source])
    kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ, ra.KERNEL]
    (q, k, v), (rq, kp, vp, tbl, pos) = kernel_inputs(torch, seed)
    zero(kernels)
    o, lse = fa._fwd_call(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
    out = ra.ragged_decode_attention(rq, kp, vp, tbl[:, :32], pos,
                                     scale=rq.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    return {"o": o, "lse": lse, "ragged": out, "launches": counts(kernels),
            "nvcc_built": sorted(built),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count(),
            "device_name": torch.cuda.get_device_name(0)}


def runtime_checks(torch, rt, card: str, phase4: dict, prepare=None) -> dict:
    """Phase 13: the port's runtime on the card. 13a resources, 13b the two
    serving kernels in a GPU task (CUDA tensors back through the store),
    13c phase 4's serve() in a num_gpus=1 actor, token-exact to phase 4,
    13d GPU accounting, 13e numbers; then shutdown leaves no worker and no
    shm segment of the session."""
    import glob

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ragged_paged_attention as ra

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    info = rt.init(num_cpus=4)
    init_s = time.perf_counter() - t0
    sid = info["session_id"]
    node = rt._private.api._node
    out = {"init_s": init_s, "session": sid}
    try:
        # 13a: resources
        res = rt.cluster_resources()
        out["cluster_resources"] = res
        if res.get("GPU") != torch.cuda.device_count():
            fail(f"13a: cluster GPU {res.get('GPU')} != "
                 f"{torch.cuda.device_count()} visible to the driver")

        # 13e: a GPU worker's boot (spawn, register, run a task that imports
        # nothing), then the same worker's first torch import and CUDA
        # context (13a's task), then a no-op GPU task's round trip
        @rt.remote(num_gpus=1)
        def noop():
            return None

        t0 = time.perf_counter()
        rt.get(noop.remote(), timeout=300)
        out["gpu_worker_boot_s"] = time.perf_counter() - t0

        @rt.remote(num_gpus=1)
        def gpu_env():
            import os

            import torch

            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    rt.get_runtime_context().get_accelerator_ids()["GPU"],
                    torch.cuda.device_count())

        @rt.remote
        def cpu_env():
            import os

            import torch

            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    torch.cuda.is_available())

        t0 = time.perf_counter()
        visible, grant, n_dev = rt.get(gpu_env.remote(), timeout=300)
        out["gpu_worker_torch_cuda_s"] = time.perf_counter() - t0
        if visible != ",".join(grant) or n_dev != 1:
            fail(f"13a: a num_gpus=1 task sees CUDA_VISIBLE_DEVICES="
                 f"{visible!r} for grant {grant} and {n_dev} devices")
        cpu_visible, cpu_cuda = rt.get(cpu_env.remote(), timeout=300)
        if cpu_cuda or cpu_visible != "":
            fail(f"13a: a CPU task sees CUDA (CUDA_VISIBLE_DEVICES="
                 f"{cpu_visible!r}, is_available {cpu_cuda})")
        out["13a"] = {"gpu_task": [visible, grant, n_dev],
                      "cpu_task": [cpu_visible, cpu_cuda]}

        t0 = time.perf_counter()
        for _ in range(50):
            rt.get(noop.remote(), timeout=120)
        out["gpu_task_roundtrip_ms"] = (time.perf_counter() - t0) / 50 * 1e3

        # 13b: the kernels in a worker, CUDA tensors through the store
        got = rt.get(rt.remote(num_gpus=1)(worker_kernels).remote(
            RT_SEED, prepare), timeout=600)
        for key in ("o", "lse", "ragged"):
            t = got[key]
            if not (isinstance(t, torch.Tensor) and t.is_cuda):
                fail(f"13b: {key} came back as {type(t).__name__} on "
                     f"{getattr(t, 'device', None)}, not a CUDA tensor")
        if got["o"].dtype != torch.bfloat16 or got["ragged"].dtype != \
                torch.bfloat16:
            fail(f"13b: dtypes {got['o'].dtype}, {got['ragged'].dtype}")
        (q, k, v), (rq, kp, vp, tbl, pos) = kernel_inputs(torch, RT_SEED)
        o_ref, lse_ref = fa.flash_attention_forward_plain(
            q.float(), k.float(), v.float(), causal=True,
            scale=q.shape[-1] ** -0.5)
        o_ref = o_ref.to(torch.bfloat16).float()
        r_ref = ra.ragged_decode_attention_reference(
            rq, kp, vp, tbl[:, :32], pos, scale=rq.shape[-1] ** -0.5).float()
        errs = {"flash_o": (got["o"].float() - o_ref).abs().max().item(),
                "flash_lse": (got["lse"] - lse_ref).abs().max().item(),
                "ragged": (got["ragged"].float() - r_ref).abs().max().item()}
        if not (torch.allclose(got["o"].float(), o_ref, atol=ATOL, rtol=RTOL)
                and errs["flash_lse"] <= LSE_TOL
                and torch.allclose(got["ragged"].float(), r_ref, atol=ATOL,
                                   rtol=RTOL)):
            fail(f"13b: the worker's kernels disagree with the plain "
                 f"versions: {errs}")
        want = {fa.KERNEL.symbol: 1, ra.KERNEL.symbol: 1,
                fa.KERNEL_DKV.symbol: 0, fa.KERNEL_DQ.symbol: 0}
        if got["launches"] != want:
            fail(f"13b: worker launches {got['launches']} != {want}")
        out["13b"] = {"max_abs_err": errs, "launches": got["launches"],
                      "nvcc_built_in_worker": got["nvcc_built"],
                      "worker_sees": [got["visible"], got["device_count"],
                                      got["device_name"]]}
        print(f"13b: the GPU worker {'ran nvcc for ' + str(got['nvcc_built']) if got['nvcc_built'] else 'loaded the driver build (no nvcc)'}",
              flush=True)
        del got, q, k, v, rq, kp, vp, tbl, pos, o_ref, lse_ref, r_ref

        # 13e: put/get of a CPU and a CUDA tensor, three times each: the
        # first put into fresh arena space faults its tmpfs pages in
        for where in ("cpu", "cuda"):
            x = torch.ones(RT_BYTES // 4, dtype=torch.float32,
                           device=torch.device(where))
            rates = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = rt.put(x)
                put_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                y = rt.get(ref)
                torch.cuda.synchronize()
                get_s = time.perf_counter() - t0
                if y.device.type != where or not torch.equal(y, x):
                    fail(f"13e: a {where} tensor came back on {y.device} "
                         "or changed")
                rates.append((RT_BYTES / put_s / 1e9,
                              RT_BYTES / get_s / 1e9))
                del y, ref
            out[f"put_get_{where}_GBps"] = rates
            del x

        # 13c: phase 4's serve() in a num_gpus=1 actor
        @rt.remote(num_gpus=1)
        class Server:
            def ready(self):
                return os.getpid()

            def serve(self):
                import torch

                if prepare is not None:
                    prepare()
                from ray_tpu_torch.ops import _build
                from ray_tpu_torch.ops import flash_attention as fa
                from ray_tpu_torch.ops import ragged_paged_attention as ra

                built = _build.build_all([fa.KERNEL.source,
                                          ra.KERNEL.source])
                try:
                    res = serve(torch, [fa.KERNEL, fa.KERNEL_DKV,
                                        fa.KERNEL_DQ, ra.KERNEL])
                except SystemExit as e:  # fail() in the worker: re-raised
                    raise RuntimeError(str(e)) from None
                res["nvcc_built"] = sorted(built)
                return res

        # on the warm GPU worker 13b left idle; serve() twice: the first
        # run is the process's first model work, the second a warm one
        t0 = time.perf_counter()
        first = Server.remote()
        rt.get(first.ready.remote(), timeout=300)
        out["gpu_actor_start_s"] = time.perf_counter() - t0
        runs = []
        for run in ("first", "second"):
            actor = rt.get(first.serve.remote(), timeout=900)
            if actor["fingerprints"] != phase4["fingerprints"]:
                fail(f"13c: the actor's weights differ from phase 4's: "
                     f"{actor['fingerprints']} vs {phase4['fingerprints']}")
            if actor["tokens"] != phase4["tokens"]:
                diff = [i for i, (a, b) in enumerate(zip(actor["tokens"],
                                                         phase4["tokens"]))
                        if a != b]
                fail(f"13c: the actor's {run} run's tokens differ from "
                     f"phase 4's in requests {diff}")
            runs.append({k: actor[k] for k in (
                "prefill_ms_mean", "decode_step_ms_mean", "decode_steps",
                "tokens_per_s", "engine_build_s", "launches",
                "nvcc_built")})
        out["13c"] = {"first": runs[0], "second": runs[1],
                      "launches": runs[0]["launches"],
                      "phase4_prefill_ms_mean": phase4["prefill_ms_mean"],
                      "phase4_decode_step_ms_mean":
                          phase4["decode_step_ms_mean"]}

        # 13d: one card, one num_gpus=1 actor at a time
        second = Server.remote()
        ready = second.ready.remote()
        try:
            rt.get(ready, timeout=5)
            fail("13d: a second num_gpus=1 actor started while the first "
                 "held the only GPU")
        except rt.exceptions.GetTimeoutError:
            pass
        t0 = time.perf_counter()
        rt.kill(first)
        rt.get(ready, timeout=300)
        out["second_gpu_actor_after_kill_s"] = time.perf_counter() - t0
        rt.kill(second)
        out["13d"] = "second GPU actor waited, started after kill(first)"
        pids = [p.pid for p in node._procs]
        # the session's segments carry the port's prefix only (another
        # process's rtpu_ sessions on this host are not ours to judge)
        out["session_segments_live"] = len(glob.glob(f"/dev/shm/rtpt_{sid}*"))
        wrong = glob.glob(f"/dev/shm/rtpu_{sid}*")
        if wrong:
            fail(f"13: the port's session made rtpu_ segments: {wrong}")
    finally:
        rt.shutdown()
    # after shutdown: no worker and no segment of the session
    deadline = time.monotonic() + 30
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = [p for p in pids if os.path.exists(f"/proc/{p}")
                 and "zombie" not in open(f"/proc/{p}/status").read().lower()]
        time.sleep(0.1)
    if alive:
        fail(f"13: worker processes {alive} outlived shutdown()")
    left = (glob.glob(f"/dev/shm/rtpt_{sid}*")
            + glob.glob(f"/dev/shm/rtpu_{sid}*"))
    if left:
        fail(f"13: shm segments of the session left: {left}")
    out["workers_spawned"] = len(pids)
    c = out["13c"]
    print(f"runtime on {card}: init {out['init_s']:.3f} s, GPU worker boot "
          f"{out['gpu_worker_boot_s']:.3f} s (+ torch and CUDA "
          f"{out['gpu_worker_torch_cuda_s']:.3f} s), no-op GPU task "
          f"{out['gpu_task_roundtrip_ms']:.3f} ms; put/get 256 MiB (GB/s, "
          f"3 rounds) cpu {out['put_get_cpu_GBps']}, cuda "
          f"{out['put_get_cuda_GBps']}; actor prefill "
          f"{c['first']['prefill_ms_mean']:.3f} / "
          f"{c['second']['prefill_ms_mean']:.3f} ms (first / second run; "
          f"phase 4 {phase4['prefill_ms_mean']:.3f}), decode step "
          f"{c['first']['decode_step_ms_mean']:.3f} / "
          f"{c['second']['decode_step_ms_mean']:.3f} ms (phase 4 "
          f"{phase4['decode_step_ms_mean']:.3f})", flush=True)
    return out


# ----------------------------------------------------------------- phase 14

# every request of phases 14-21 and its in-process expectation: cut from
# 32 to make room on a slower host (the script took 943.0 s on one H100
# host and 1179.9 s on another, PERF.md); every gate still compares each
# token
HTTP_MAX_TOKENS = 16
HTTP_STREAM_PROMPT = 3          # 14c's SSE stream: the 300-token prompt


def http_prompts() -> list[str]:
    """14b's prompts: printable ASCII text that the ByteTokenizer turns into
    SERVE_LENGTHS tokens each (one BOS plus a token a byte)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 14)
    return ["".join(chr(c) for c in rng.integers(32, 127, size=n - 1))
            for n in SERVE_LENGTHS]


def http_expected(torch, cfg, params) -> list[dict]:
    """What 14b must return: an in-process LLMEngine, built as the replica
    builds its engine (LLMEngine.from_config with phase 4's engine options)
    on phase 10's weights, serving each prompt alone, one after the other,
    with the server's sampling parameters (greedy, the byte EOS as stop
    token). Run while phase 10's model is alive."""
    from ray_tpu_torch.llm import (ByteTokenizer, LLMConfig, LLMEngine,
                                   SamplingParams)

    built = LLMConfig(engine_kwargs=http_engine_kwargs())
    built.build_model = lambda device=None: (cfg, params)
    tok = ByteTokenizer()
    eng = LLMEngine.from_config(built)
    try:
        sp = SamplingParams(max_tokens=HTTP_MAX_TOKENS, temperature=0.0,
                            stop_token_ids=(tok.eos_token_id,))
        out = []
        for text in http_prompts():
            ids = eng.generate(tok.encode(text), sp)
            out.append({"ids": ids, "text": tok.decode(ids)})
    finally:
        eng.shutdown()
    return out


def http_engine_kwargs() -> dict:
    return {"kv_layout": "paged", "page_size": 64, "max_slots": 8,
            "max_len": 2048, "seed": SEED}


def process_start_time() -> float:
    """Wall-clock start of this process, from /proc."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def probe_server(base, prepare=None):
    """The LLM server's class with probes, for 14's replica: when its
    process started, when CUDA was ready and when the model was built; the
    token ids of every request it served, read in the replica; its launch
    counts and weight fingerprints. Defined here, so nothing is added to
    the package; pickled by value into the replica."""

    class ProbeServer(base):
        def __init__(self, llm_config):
            import os
            import time

            t_enter = time.time()
            started = process_start_time()
            if prepare is not None:
                prepare()
            import torch

            torch.empty(1, device=torch.device("cuda"))
            torch.cuda.synchronize()
            t_cuda = time.time()
            super().__init__(llm_config)
            torch.cuda.synchronize()
            self.probe = {"process_start": started, "init_enter": t_enter,
                          "cuda_ready": t_cuda, "model_built": time.time(),
                          "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                          "pid": os.getpid()}
            self.records: list = []

        def _submit_retry(self, ids, params, lora):
            req = super()._submit_retry(ids, params, lora)
            rec = {"prompt_tokens": len(ids), "ids": []}
            self.records.append(rec)

            def tokens():
                for t in req:
                    rec["ids"].append(t)
                    yield t

            return tokens()

        def probe_state(self, zero_counts: bool = False) -> dict:
            from ray_tpu_torch.ops import flash_attention as fa
            from ray_tpu_torch.ops import ragged_paged_attention as ra

            kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ, ra.KERNEL]
            out = {"launches": {k.symbol: k.launches for k in kernels},
                   "stats": self.engine.stats(),
                   "records": list(self.records),
                   "n_layers": self.engine.cfg.n_layers, **self.probe}
            if zero_counts:
                for k in kernels:
                    k.launches = 0
                self.records.clear()
            return out

        def probe_fingerprints(self) -> dict:
            import torch

            return weight_fingerprints(torch, self.engine.params)

    return ProbeServer


def http_post(port: int, path: str, body: dict, timeout: float = 600):
    """(seconds, status, decoded JSON) of one POST on a fresh connection."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    payload = json.dumps(body)
    t0 = time.perf_counter()
    try:
        conn.request("POST", path, body=payload,
                     headers={"Content-Type": "application/json",
                              "Content-Length": str(len(payload))})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return time.perf_counter() - t0, resp.status, json.loads(data)


def http_sse(port: int, path: str, body: dict, timeout: float = 600):
    """(seconds to the first chunk, seconds to the end, status, the chunks'
    JSON objects) of one SSE POST."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    payload = json.dumps(body)
    t0 = time.perf_counter()
    first = None
    chunks, buf = [], b""
    try:
        conn.request("POST", path, body=payload,
                     headers={"Content-Type": "application/json",
                              "Accept": "text/event-stream",
                              "Content-Length": str(len(payload))})
        resp = conn.getresponse()
        while resp.status == 200:
            data = resp.read1(65536)
            if not data:
                break
            buf += data
            while b"\n\n" in buf:
                raw, buf = buf.split(b"\n\n", 1)
                if raw.startswith(b"data: "):
                    if first is None:
                        first = time.perf_counter() - t0
                    chunks.append(raw[len(b"data: "):].decode())
    finally:
        conn.close()
    return first, time.perf_counter() - t0, resp.status, chunks


def openai_shape(out: dict) -> str | None:
    """What is wrong with a text_completion response, or None."""
    try:
        ch = out["choices"][0]
        ok = (out["object"] == "text_completion" and isinstance(ch["text"], str)
              and ch["finish_reason"] == "stop"
              and isinstance(out["usage"]["prompt_tokens"], int)
              and 0 <= out["usage"]["completion_tokens"] <= HTTP_MAX_TOKENS)
    except (KeyError, IndexError, TypeError):
        ok = False
    return None if ok else f"not an OpenAI completion of <= " \
        f"{HTTP_MAX_TOKENS} tokens: {str(out)[:300]}"


def serve_http(torch, rt, card: str, phase4: dict, phase13: dict,
               expected: list[dict], prepare=None) -> dict:
    """Phase 14: Llama-3-8B over HTTP from a num_gpus=1 Serve replica.
    14a start, 14b sequential requests token-exact to in-process serving,
    14c a concurrent wave and SSE streams, 14d launches in the replica,
    14e times, 14f teardown leaves no segment of the session."""
    import glob
    import threading

    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMConfig, ModelLoadingConfig
    from ray_tpu_torch.llm import build_openai_app
    from ray_tpu_torch.serve.deployment import Deployment

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    t_phase = time.perf_counter()
    segs = ("/dev/shm/rtpt_routes_*", "/dev/shm/rtpt_chan_*")
    before = {p for g in segs for p in glob.glob(g)}
    info = rt.init(num_cpus=4)
    sid = info["session_id"]
    prompts = http_prompts()
    out = {"session": sid}
    try:
        # 14a: the app, its replica holding the card
        serve.start(http_port=0)
        host, port = serve.http_address()
        app = build_openai_app(LLMConfig(
            model_loading_config=ModelLoadingConfig(model_id="8b"),
            model_family="llama", engine_kwargs=http_engine_kwargs(),
            deployment_config={"ray_actor_options": {"num_gpus": 1}}))
        dep = app.deployment
        app.deployment = Deployment(probe_server(dep.func_or_class, prepare),
                                    dep.name, dep.config)
        full = f"llm_{dep.name}"
        t_run = time.time()
        handle = serve.run(app, name="llm", route_prefix="/llm")
        # HEALTHY: the replica count is at target; its health turns
        # "healthy" at the first probe it passes, after its __init__
        deadline = time.monotonic() + 600
        healthy_s = None
        while True:
            st = serve.status().get(full, {})
            if healthy_s is None and st.get("status") == "HEALTHY":
                healthy_s = time.time() - t_run
            health = set(st.get("replica_health", {}).values())
            if healthy_s is not None and health == {"healthy"}:
                break
            if time.monotonic() > deadline:
                fail(f"14a: {full} not healthy after 600 s: {st}")
            time.sleep(0.05)
        ready_s = time.time() - t_run
        if dep.config.request_router != "prefix_aware" or \
                dep.config.ray_actor_options != {"num_gpus": 1}:
            fail(f"14a: build_openai_app's options {dep.config}")
        probe = handle.probe_state.remote(True).result(timeout_s=120)
        if probe["visible"] in (None, ""):
            fail(f"14a: the replica sees CUDA_VISIBLE_DEVICES="
                 f"{probe['visible']!r}")
        fps = handle.probe_fingerprints.remote().result(timeout_s=120)
        if fps != phase4["fingerprints"]:
            fail(f"14a: the replica's weights differ from phase 4's: {fps}")
        out["14a"] = {
            "serve_run_to_HEALTHY_s": healthy_s,
            "serve_run_to_first_probe_passed_s": ready_s,
            # negative: the pool had started the worker before serve.run
            "replica_process_start_s": probe["process_start"] - t_run,
            "process_to_init_s": probe["init_enter"] - probe["process_start"],
            "cuda_context_s": probe["cuda_ready"] - probe["init_enter"],
            "model_build_s": probe["model_built"] - probe["cuda_ready"],
            "replica_visible": probe["visible"], "http_port": port}

        # 14b: one request at a time, each token-exact to in-process serving
        path = "/llm/v1/completions"
        seq = []
        for text, want in zip(prompts, expected):
            s, status, body = http_post(port, path, {
                "prompt": text, "max_tokens": HTTP_MAX_TOKENS,
                "temperature": 0.0})
            bad = openai_shape(body) if status == 200 else f"HTTP {status}"
            if bad:
                fail(f"14b: {bad}")
            seq.append((s, body))
        probe = handle.probe_state.remote().result(timeout_s=120)
        got_ids = [r["ids"] for r in probe["records"]]
        want_ids = [w["ids"] for w in expected]
        if got_ids != want_ids:
            diff = [i for i, (a, b) in enumerate(zip(got_ids, want_ids))
                    if a != b]
            fail(f"14b: the replica's token ids differ from in-process "
                 f"serving in requests {diff} (of {len(got_ids)})")
        for i, ((_, body), want) in enumerate(zip(seq, expected)):
            if (body["choices"][0]["text"] != want["text"]
                    or body["usage"]["completion_tokens"] != len(want["ids"])):
                fail(f"14b: request {i}'s text or token count differs from "
                     f"in-process serving")
        out["14b"] = {"latency_s": [s for s, _ in seq],
                      "completion_tokens": [b["usage"]["completion_tokens"]
                                            for _, b in seq],
                      "prompt_tokens": [b["usage"]["prompt_tokens"]
                                        for _, b in seq]}

        # 14c: the 8 prompts at once plus one SSE stream, then that stream
        # alone, whose chunks must join to 14b's text of its prompt
        body_of = [{"prompt": t, "max_tokens": HTTP_MAX_TOKENS,
                    "temperature": 0.0} for t in prompts]
        results: list = [None] * (len(prompts) + 1)

        def call(i):
            if i < len(prompts):
                results[i] = http_post(port, path, body_of[i])
            else:
                results[i] = http_sse(port, path,
                                      body_of[HTTP_STREAM_PROMPT])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(results))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wave_s = time.perf_counter() - t0
        if any(r is None for r in results):
            fail("14c: a concurrent request did not return")
        for i, (s, status, body) in enumerate(results[:-1]):
            bad = openai_shape(body) if status == 200 else f"HTTP {status}"
            if bad:
                fail(f"14c: request {i}: {bad}")
        agree = [body["choices"][0]["text"] == w["text"]
                 and body["usage"]["completion_tokens"] == len(w["ids"])
                 for (_, _, body), w in zip(results[:-1], expected)]
        # the wave's ids as the replica saw them (the stream's request has
        # the same prompt as request HTTP_STREAM_PROMPT: either may match)
        wave = [(r["prompt_tokens"], r["ids"]) for r in handle.probe_state
                .remote().result(timeout_s=120)["records"][len(prompts):]]
        ids_agree = [(n, w["ids"]) in wave
                     for n, w in zip(SERVE_LENGTHS, expected)]

        def joined(chunks, status, what):
            if status != 200 or not chunks or chunks[-1] != "[DONE]":
                fail(f"14c: the {what} SSE stream ended with HTTP {status}, "
                     f"last chunk {chunks[-1:]}")
            objs = [json.loads(c) for c in chunks[:-1]]
            if any(o.get("object") != "text_completion.chunk" for o in objs):
                fail(f"14c: {what} stream chunk not text_completion.chunk")
            if objs[-1]["choices"][0]["finish_reason"] != "stop" or \
                    len(objs) - 1 > HTTP_MAX_TOKENS:
                fail(f"14c: the {what} stream has {len(objs) - 1} tokens or "
                     f"no final stop chunk")
            return "".join(o["choices"][0]["text"] for o in objs), len(objs) - 1

        wave_ttft, wave_stream_s, st, chunks = results[-1]
        wave_text, wave_n = joined(chunks, st, "concurrent")
        ttft, stream_s, st, chunks = http_sse(port, path,
                                              body_of[HTTP_STREAM_PROMPT])
        alone_text, alone_n = joined(chunks, st, "lone")
        want = expected[HTTP_STREAM_PROMPT]
        lone_ids = handle.probe_state.remote().result(
            timeout_s=120)["records"][-1]["ids"]
        if lone_ids != want["ids"]:
            fail("14c: the lone stream's token ids differ from in-process "
                 "serving of its prompt")
        if alone_text != want["text"] or alone_n != len(want["ids"]):
            fail(f"14c: the lone stream's chunks ({alone_n} tokens) do not "
                 f"join to its prompt's non-streamed text "
                 f"({len(want['ids'])} tokens)")
        tokens = sum(b["usage"]["completion_tokens"]
                     for _, _, b in results[:-1]) + wave_n
        out["14c"] = {
            "wave_s": wave_s, "latency_s": [r[0] for r in results[:-1]],
            "stream_s": wave_stream_s, "stream_ttft_s": wave_ttft,
            "tokens": tokens, "tokens_per_s": tokens / wave_s,
            "agree_with_14b_text_and_count": agree,
            "agree_with_14b_ids": ids_agree,
            "stream_agrees_with_14b": wave_text == want["text"]
            and wave_n == len(want["ids"]),
            "lone_stream_ttft_s": ttft, "lone_stream_s": stream_s}

        # 14d: the launches of 14b and 14c, counted in the replica
        probe = handle.probe_state.remote().result(timeout_s=120)
        st = probe["stats"]
        launches = probe["launches"]
        steps, prefills = st["decode_steps"], st["prefills"]
        n_layers = probe["n_layers"]
        if n_layers != 32:
            fail(f"14d: the replica's model has {n_layers} layers, not 32")
        want_l = {"flash_attention_fwd_bf16": n_layers * prefills,
                  "ragged_paged_attention_bf16": n_layers * steps}
        for sym, n in launches.items():
            if n != want_l.get(sym, 0):
                fail(f"14d: {sym} launched {n} times in the replica, "
                     f"expected {want_l.get(sym, 0)} ({prefills} prefills, "
                     f"{steps} decode steps)")
        out["launches"] = launches
        out["14d"] = {"prefills": prefills, "decode_steps": steps}
        out["replica_prefill_ms_mean"] = 1e3 * st["prefill_seconds"] / prefills
        out["replica_decode_step_ms_mean"] = 1e3 * st["decode_seconds"] / steps
        stats = http_post(port, "/llm/v1/stats", {})[2]
        if stats.get("decode_steps") != steps:
            fail(f"14d: /v1/stats {stats}")
        serve.shutdown()
    finally:
        rt.shutdown()
    # 14f: nothing of the session is left
    left = ({p for g in segs for p in glob.glob(g)} - before) | set(
        glob.glob(f"/dev/shm/rtpt_{sid}*"))
    if left:
        fail(f"14f: shm segments of the session left: {sorted(left)}")
    out["phase_s"] = time.perf_counter() - t_phase
    a, b, c = out["14a"], out["14b"], out["14c"]
    c13 = phase13["13c"]["second"]
    print(f"serve over HTTP on {card}: serve.run to HEALTHY "
          f"{a['serve_run_to_HEALTHY_s']:.3f} s, to the first probe passed "
          f"{a['serve_run_to_first_probe_passed_s']:.3f} s (the replica's "
          f"process started at {a['replica_process_start_s']:.3f}, imports "
          f"{a['process_to_init_s']:.3f}, CUDA context "
          f"{a['cuda_context_s']:.3f}, model build {a['model_build_s']:.3f}); "
          f"sequential latency {min(b['latency_s']):.3f}-"
          f"{max(b['latency_s']):.3f} s, concurrent "
          f"{min(c['latency_s']):.3f}-{max(c['latency_s']):.3f} s, "
          f"{c['tokens_per_s']:.1f} tokens/s; lone SSE TTFT "
          f"{c['lone_stream_ttft_s'] * 1e3:.3f} ms; replica prefill "
          f"{out['replica_prefill_ms_mean']:.3f} ms, decode step "
          f"{out['replica_decode_step_ms_mean']:.3f} ms (phase 4 "
          f"{phase4['prefill_ms_mean']:.3f} / "
          f"{phase4['decode_step_ms_mean']:.3f}, 13c "
          f"{c13['prefill_ms_mean']:.3f} / {c13['decode_step_ms_mean']:.3f}"
          f"); phase 14 took {out['phase_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------- phase 15

PD_ENV = {"RAY_TPU_TORCH_WORKER_PLATFORM": "cuda",   # pools reach the card
          "RAY_TPU_TORCH_SERVE_SPAN_SAMPLE_EVERY": "1"}  # 15d's span tree
PD_DROP_TOKENS = 256    # 15c's dropped stream: still decoding when it drops
PD_SPANS = {"serve:request", "proxy:route", "pd:prefill", "pd:kv_send",
            "pd:kv_transfer", "pd:admission", "pd:decode"}
PD_WAIT_S_HTTP = 60.0


def pd_expected(torch, cfg, params) -> dict:
    """What 15b must return: an in-process LLMEngine on _pd_engine_kwargs of
    phase 15's engine options (the PD pools' shapes) and phase 10's
    weights, serving each prompt alone, greedy, 16 tokens, no stop token
    (the PD proxy passes none). Beside it, per prompt, how far the prefill
    tier's call (``prefill_batch`` at B = 1) and the engine's
    (``decoding.prefill``) are apart in bf16 logits. Run while phase 10's
    model is alive."""
    from ray_tpu_torch.llm import (ByteTokenizer, LLMConfig, LLMEngine,
                                   SamplingParams)
    from ray_tpu_torch.llm.engine import bucket_for
    from ray_tpu_torch.llm.pd import _pd_engine_kwargs
    from ray_tpu_torch.models import decoding

    ek = _pd_engine_kwargs(LLMConfig(engine_kwargs=http_engine_kwargs()))
    built = LLMConfig(engine_kwargs=ek)
    built.build_model = lambda device=None: (cfg, params)
    tok = ByteTokenizer()
    eng = LLMEngine.from_config(built)
    try:
        sp = SamplingParams(max_tokens=HTTP_MAX_TOKENS, temperature=0.0)
        out = []
        for text in http_prompts():
            ids = eng.generate(tok.encode(text), sp)
            out.append({"ids": ids, "text": tok.decode(ids)})
    finally:
        eng.shutdown()
    rows = []
    dev = params["embed"].device
    with torch.no_grad():
        for text in http_prompts():
            ids = tok.encode(text)
            bucket = bucket_for(len(ids), ek["min_bucket"], ek["max_len"])
            toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
            toks[0, :len(ids)] = torch.as_tensor(ids, device=dev)
            solo = decoding.prefill(params, toks, len(ids), cfg)[0]
            batched = decoding.prefill_batch(params, toks, [len(ids)],
                                             cfg)[0][0]
            rows.append({"max_abs_diff": float((solo - batched).abs().max()),
                         "same_argmax": int(solo.argmax()) ==
                         int(batched.argmax())})
    return {"expected": out, "prefill_batch_vs_prefill": rows}


def pd_probe(base, role: str, prepare=None):
    """A PD deployment's class with probes, for phase 15's replicas (role
    "prefill", "decode" or "proxy"): when its process started and when it
    was built, whether it holds a CUDA context, its launch counts and
    weight fingerprints; in the decode replica, the token ids of every
    request and each page transfer's pages, bytes and seconds (pull to last
    page). Defined here, so nothing is added to the package; pickled by
    value into the replica."""

    class PDProbe(base):
        def __init__(self, *args, **kwargs):
            import time

            t_enter = time.time()
            started = process_start_time()
            if prepare is not None:
                prepare()
            import torch

            super().__init__(*args, **kwargs)
            if role != "proxy":
                torch.cuda.synchronize()
            self.probe = {"process_start": started, "init_enter": t_enter,
                          "built": time.time(), "pid": os.getpid(),
                          "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                          "granted": os.environ.get(
                              "RAY_TPU_TORCH_WORKER_GPUS", "")}
            self.records: list = []
            self.transfers: list = []
            self.base = self._counters()
            if role == "decode" and self.puller is not None:
                real_pull = self.puller.pull

                def pull(ticket, stream, timeout_s=60.0):
                    t0 = time.time()
                    real_pull(ticket, stream, timeout_s=timeout_s)
                    self.transfers.append((ticket, stream, t0))

                self.puller.pull = pull

        def _counters(self) -> dict:
            if role == "prefill":
                return {"forwards": self.coalescer.batches,
                        "jobs": self.coalescer.jobs}
            if role == "decode":
                st = self.engine.stats()
                return {"decode_steps": st["decode_steps"],
                        "prefills": st["prefills"], "aborts": st["aborts"]}
            return {}

        def probe_state(self, zero_counts: bool = False) -> dict:
            import torch

            from ray_tpu_torch.ops import flash_attention as fa
            from ray_tpu_torch.ops import ragged_paged_attention as ra

            kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ, ra.KERNEL]
            now = self._counters()
            out = {"launches": {k.symbol: k.launches for k in kernels},
                   "cuda_initialized": torch.cuda.is_initialized(),
                   "counts": {k: v - self.base[k] for k, v in now.items()},
                   **self.probe}
            if role == "prefill":
                out["stats"] = self.transfer_stats()
                out["n_layers"] = self.cfg.n_layers
            if role == "decode":
                out["stats"] = self.engine_stats()
                out["n_layers"] = self.engine.cfg.n_layers
                out["records"] = list(self.records)
                out["transfers"] = []
                for ticket, stream, t0 in self.transfers:
                    item = torch.empty((), dtype=getattr(
                        torch, ticket["dtype"])).element_size()
                    page = 2 * item
                    for d in ticket["page_shape"]:
                        page *= d
                    out["transfers"].append({
                        "pages": ticket["n_pages"],
                        "bytes": ticket["n_pages"] * page,
                        "s": (stream.finished_ts or t0) - t0})
            if zero_counts:
                for k in kernels:
                    k.launches = 0
                self.records.clear()
                self.transfers.clear()
                self.base = now
            return out

        def probe_fingerprints(self) -> dict:
            import torch

            params = self.params if role == "prefill" else self.engine.params
            return weight_fingerprints(torch, params)

    if role != "decode":
        return PDProbe

    class DecodeProbe(PDProbe):
        def decode_stream(self, ticket, params=None):
            rec = {"length": ticket["length"], "ids": []}
            self.records.append(rec)
            gen = super().decode_stream(ticket, params)
            try:
                for t in gen:
                    rec["ids"].append(t)
                    yield t
            finally:
                gen.close()

    return DecodeProbe


def pd_shape(out: dict, n_max: int = HTTP_MAX_TOKENS) -> str | None:
    """What is wrong with a PD proxy reply, or None."""
    try:
        ch, u = out["choices"][0], out["usage"]
        ok = (isinstance(ch["text"], str) and ch["finish_reason"] == "stop"
              and isinstance(u["prompt_tokens"], int)
              and 0 <= u["completion_tokens"] <= n_max
              and 0 < u["ttft_s"] <= u["total_time_s"])
    except (KeyError, IndexError, TypeError):
        ok = False
    return None if ok else f"not a PD proxy completion of <= {n_max} " \
        f"tokens with 0 < ttft_s <= total_time_s: {str(out)[:300]}"


def sse_joined(chunks, status, what: str) -> tuple[str, int]:
    """The text and token count of a PD proxy SSE stream; fails 15c when
    it is not one chunk a token, a final stop chunk with usage, and
    ``[DONE]``."""
    if status != 200 or not chunks or chunks[-1] != "[DONE]":
        fail(f"15c: the {what} SSE stream ended with HTTP {status}, last "
             f"chunk {chunks[-1:]}")
    objs = [json.loads(c) for c in chunks[:-1]]
    if any(o.get("object") != "text_completion.chunk" for o in objs):
        fail(f"15c: {what} stream chunk not text_completion.chunk")
    last = objs[-1]
    n = len(objs) - 1
    if last["choices"][0]["finish_reason"] != "stop" or \
            last.get("usage", {}).get("completion_tokens") != n or \
            n > HTTP_MAX_TOKENS:
        fail(f"15c: the {what} stream has {n} tokens and final chunk "
             f"{str(last)[:200]}")
    return "".join(o["choices"][0]["text"] for o in objs), n


def sse_drop(port: int, path: str, body: dict) -> float:
    """Open an SSE stream, read up to its first chunk, and drop the client
    (response and connection both closed, so the proxy sees the socket
    go). Returns the seconds to the first chunk."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    payload = json.dumps(body)
    t0 = time.perf_counter()
    try:
        conn.request("POST", path, body=payload,
                     headers={"Content-Type": "application/json",
                              "Accept": "text/event-stream",
                              "Content-Length": str(len(payload))})
        resp = conn.getresponse()
        if resp.status != 200:
            fail(f"15c: the dropped stream got HTTP {resp.status}")
        buf = b""
        while b"data: " not in buf:
            data = resp.read1(65536)
            if not data:
                fail("15c: the dropped stream ended before its first chunk")
            buf += data
        first = time.perf_counter() - t0
        resp.close()
    finally:
        conn.close()
    return first


def serve_pd_http(torch, rt, card: str, phase4: dict, phase14: dict,
                  fps10: dict, ref: dict, prepare=None) -> dict:
    """Phase 15: Llama-3-8B disaggregated over HTTP, a prefill replica and
    a decode replica sharing the card. 15a start, 15b sequential requests
    token-exact to in-process serving, 15c a concurrent wave, SSE streams
    and a dropped client, 15d a sampled request's span tree, 15e launches
    in each replica, 15f times, 15g teardown leaves no segment."""
    import glob
    import threading

    from ray_tpu_torch import serve
    from ray_tpu_torch._private.api import _get_worker
    from ray_tpu_torch._private.ray_config import RayConfig
    from ray_tpu_torch.llm import LLMConfig, ModelLoadingConfig, PDConfig
    from ray_tpu_torch.llm import build_pd_openai_app
    from ray_tpu_torch.serve.deployment import Deployment
    from ray_tpu_torch.util import tracing

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    t_phase = time.perf_counter()
    segs = ("/dev/shm/rtpt_routes_*", "/dev/shm/rtpt_chan_*")
    before = {p for g in segs for p in glob.glob(g)}
    saved = {k: os.environ.get(k) for k in PD_ENV}
    os.environ.update(PD_ENV)
    RayConfig.reset()
    expected = ref["expected"]
    prompts = http_prompts()
    out = {}
    try:
        info = rt.init(num_cpus=8)
        sid = out["session"] = info["session_id"]
        # 15a: the app as build_pd_openai_app composes it, its classes
        # swapped for probing subclasses
        serve.start(http_port=0)
        host, port = serve.http_address()
        cfg = LLMConfig(
            model_loading_config=ModelLoadingConfig(model_id="8b"),
            model_family="llama", engine_kwargs=http_engine_kwargs(),
            pd_config=PDConfig())
        app = build_pd_openai_app(cfg)
        apps = app.flatten()
        composed = [(a.deployment.name, a.deployment.config.num_replicas,
                     a.deployment.config.ray_actor_options) for a in apps]
        if composed != [(n, 1, {}) for n in ("PrefillServer",
                                             "DecodeServer",
                                             "PDProxyServer")] or \
                app.init_args[2] != "byte":
            fail(f"15a: build_pd_openai_app composed {composed}, "
                 f"{app.init_args[2:]}")
        roles = {"PrefillServer": "prefill", "DecodeServer": "decode",
                 "PDProxyServer": "proxy"}
        for a in apps:
            d = a.deployment
            a.deployment = Deployment(
                pd_probe(d.func_or_class, roles[d.name], prepare), d.name,
                d.config)
        t_run = time.time()
        proxy = serve.run(app, name="pd", route_prefix="/pd")
        pools = {n: f"pd_{n}" for n in roles}
        healthy, ready = {}, {}
        deadline = time.monotonic() + 900
        while len(ready) < len(pools):
            st = serve.status()
            for n, full in pools.items():
                s = st.get(full, {})
                if n not in healthy and s.get("status") == "HEALTHY":
                    healthy[n] = time.time() - t_run
                if n in healthy and n not in ready and set(
                        s.get("replica_health", {}).values()) == {"healthy"}:
                    ready[n] = time.time() - t_run
            if time.monotonic() > deadline:
                fail(f"15a: the PD pools not healthy after 900 s: {st}")
            time.sleep(0.05)
        pre = serve.get_deployment_handle("PrefillServer", "pd")
        dec = serve.get_deployment_handle("DecodeServer", "pd")
        probes = {"prefill": pre.probe_state.remote(True).result(
                      timeout_s=120),
                  "decode": dec.probe_state.remote(True).result(
                      timeout_s=120),
                  "proxy": proxy.probe_state.remote(True).result(
                      timeout_s=120)}
        fps = {r: h.probe_fingerprints.remote().result(timeout_s=120)
               for r, h in (("prefill", pre), ("decode", dec))}
        if not (fps["prefill"] == fps["decode"] == fps10
                == phase4["fingerprints"]):
            fail(f"15a: the replicas' weights differ from each other or "
                 f"from phase 10's: {fps} vs {fps10}")
        if probes["proxy"]["cuda_initialized"]:
            fail("15a: the PD proxy replica holds a CUDA context")
        for r, p in probes.items():
            if p["granted"]:
                fail(f"15a: the {r} replica was granted GPU "
                     f"{p['granted']!r}; build_pd_openai_app grants none")
        out["15a"] = {
            "serve_run_to_HEALTHY_s": healthy,
            "serve_run_to_first_probe_passed_s": ready,
            "replica_process_start_s": {
                r: p["process_start"] - t_run for r, p in probes.items()},
            "process_to_init_s": {
                r: p["init_enter"] - p["process_start"]
                for r, p in probes.items()},
            "init_s": {r: p["built"] - p["init_enter"]
                       for r, p in probes.items()},
            "pids": {r: p["pid"] for r, p in probes.items()},
            "http_port": port}

        # 15b: one request at a time, token-exact to in-process serving
        seq = []
        for i, text in enumerate(prompts):
            s, status, body = http_post(port, "/pd", {
                "prompt": text, "max_tokens": HTTP_MAX_TOKENS,
                "temperature": 0.0})
            bad = pd_shape(body) if status == 200 else f"HTTP {status}"
            if bad:
                fail(f"15b: request {i}: {bad}")
            if body["usage"]["completion_tokens"] != HTTP_MAX_TOKENS:
                fail(f"15b: request {i} has "
                     f"{body['usage']['completion_tokens']} tokens, not "
                     f"{HTTP_MAX_TOKENS}")
            seq.append((s, body))
        got_ids = [r["ids"] for r in dec.probe_state.remote().result(
            timeout_s=120)["records"]]
        want_ids = [w["ids"] for w in expected]
        if got_ids != want_ids:
            diff = [i for i, (a, b) in enumerate(zip(got_ids, want_ids))
                    if a != b]
            first = [got_ids[i][:1] == want_ids[i][:1] for i in diff]
            fail(f"15b: the decode replica's token ids differ from "
                 f"in-process serving in requests {diff} (of "
                 f"{len(got_ids)}; first tokens equal: {first}; prefill_batch "
                 f"at B = 1 vs decoding.prefill: "
                 f"{[ref['prefill_batch_vs_prefill'][i] for i in diff]})")
        for i, ((_, body), want) in enumerate(zip(seq, expected)):
            if body["choices"][0]["text"] != want["text"]:
                fail(f"15b: request {i}'s text differs from in-process "
                     f"serving")
        out["15b"] = {"latency_s": [s for s, _ in seq],
                      "ttft_s": [b["usage"]["ttft_s"] for _, b in seq],
                      "total_time_s": [b["usage"]["total_time_s"]
                                       for _, b in seq]}

        # 15c: the 8 prompts at once plus one SSE stream; that stream
        # alone; then a client dropped after its first chunk
        body_of = [{"prompt": t, "max_tokens": HTTP_MAX_TOKENS,
                    "temperature": 0.0} for t in prompts]
        results: list = [None] * (len(prompts) + 1)

        def call(i):
            if i < len(prompts):
                results[i] = http_post(port, "/pd", body_of[i])
            else:
                results[i] = http_sse(port, "/pd",
                                      body_of[HTTP_STREAM_PROMPT])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(results))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wave_s = time.perf_counter() - t0
        if any(r is None for r in results):
            fail("15c: a concurrent request did not return")
        for i, (s, status, body) in enumerate(results[:-1]):
            bad = pd_shape(body) if status == 200 else f"HTTP {status}"
            if bad:
                fail(f"15c: request {i}: {bad}")
        agree = [body["choices"][0]["text"] == w["text"]
                 for (_, _, body), w in zip(results[:-1], expected)]
        wave_ttft, wave_stream_s, st, chunks = results[-1]
        wave_text, wave_n = sse_joined(chunks, st, "concurrent")
        ttft, stream_s, st, chunks = http_sse(port, "/pd",
                                              body_of[HTTP_STREAM_PROMPT])
        alone_text, alone_n = sse_joined(chunks, st, "lone")
        want = expected[HTTP_STREAM_PROMPT]
        if alone_text != want["text"] or alone_n != len(want["ids"]):
            fail(f"15c: the lone stream's chunks ({alone_n} tokens) do not "
                 f"join to its prompt's non-streamed text "
                 f"({len(want['ids'])} tokens)")
        tokens = sum(b["usage"]["completion_tokens"]
                     for _, _, b in results[:-1]) + wave_n
        # the drop: the longest prompt (a threaded transfer), a budget that
        # keeps it decoding well past its first chunk
        idle = dec.probe_state.remote().result(timeout_s=120)
        aborts0 = idle["stats"]["aborts"]
        drop_ttft = sse_drop(port, "/pd", {
            "prompt": prompts[-1], "max_tokens": PD_DROP_TOKENS,
            "temperature": 0.0})
        t_drop = time.perf_counter()
        deadline = time.monotonic() + PD_WAIT_S_HTTP
        while True:
            d = dec.engine_stats.remote().result(timeout_s=120)
            p = pre.transfer_stats.remote().result(timeout_s=120)
            back = (d["free_slots"] == d["max_slots"]
                    and d["free_pages"] == d["num_pages"] - 1
                    and d["pulls_in_flight"] == 0
                    and p["pending_transfers"] == 0
                    and d["aborts"] > aborts0)
            if back:
                break
            if time.monotonic() > deadline:
                fail(f"15c: {PD_WAIT_S_HTTP} s after the drop the decode "
                     f"pool is {d} and the prefill side {p} (aborts "
                     f"before the drop {aborts0})")
            time.sleep(0.05)
        out["15c"] = {
            "wave_s": wave_s, "latency_s": [r[0] for r in results[:-1]],
            "stream_s": wave_stream_s, "stream_ttft_s": wave_ttft,
            "tokens": tokens, "tokens_per_s": tokens / wave_s,
            "agree_with_15b_text": agree,
            "stream_agrees_with_15b": wave_text == want["text"],
            "lone_stream_ttft_s": ttft, "lone_stream_s": stream_s,
            "drop_ttft_s": drop_ttft,
            "drop_to_reclaimed_s": time.perf_counter() - t_drop,
            "aborts": d["aborts"] - aborts0}

        # 15d: one sampled request's span tree over the processes
        rpc = _get_worker().rpc

        def rows(component):
            return [r for r in rpc({"type": "list_requests"}).get(
                "requests", []) if r.get("component") == component]

        # the proxy stamps a row's ts when the request arrives: the only
        # /pd row from after t_sent is this request's
        t_sent = time.time()
        s, status, body = http_post(port, "/pd", body_of[0])
        if status != 200 or pd_shape(body):
            fail(f"15d: HTTP {status} {pd_shape(body)}")
        deadline = time.monotonic() + PD_WAIT_S_HTTP
        while True:
            new = [r for r in rows("http_proxy")
                   if r.get("path") == "/pd" and r["ts"] >= t_sent]
            if new:
                break
            if time.monotonic() > deadline:
                fail("15d: no flight-recorder row of the sampled request")
            time.sleep(0.2)
        rid = new[-1]["request_id"]
        names, spans = set(), []
        while True:
            tree = tracing.get_trace(rid)
            spans = []
            stack = [tree["root"]] if tree else []
            while stack:
                sp = stack.pop()
                spans.append(sp)
                stack.extend(sp.get("children", ()))
            names = {sp.get("name") for sp in spans}
            pd_row = [r for r in rows("pd_proxy") if r["request_id"] == rid]
            if PD_SPANS <= names and pd_row:
                break
            if time.monotonic() > deadline:
                fail(f"15d: the trace of {rid} holds {sorted(names)}, "
                     f"pd_proxy rows {pd_row}")
            time.sleep(0.3)
        pids = {sp.get("pid") for sp in spans if sp.get("pid")}
        if len(pids) < 3:
            fail(f"15d: the span tree spans {len(pids)} processes")
        phases = pd_row[-1].get("phases") or {}
        if not {"prefill", "decode_first_token"} <= set(phases):
            fail(f"15d: the pd_proxy row's phases {phases}")
        out["15d"] = {"spans": sorted(n for n in names if n),
                      "processes": len(pids), "pd_proxy_phases": phases}

        # 15e: the launches of 15b-15d, counted in each replica
        probes = {"prefill": pre.probe_state.remote().result(timeout_s=120),
                  "decode": dec.probe_state.remote().result(timeout_s=120),
                  "proxy": proxy.probe_state.remote().result(timeout_s=120)}
        n_layers = probes["prefill"]["n_layers"]
        if n_layers != 32 or probes["decode"]["n_layers"] != 32:
            fail(f"15e: the replicas' models have {n_layers} and "
                 f"{probes['decode']['n_layers']} layers, not 32")
        forwards = probes["prefill"]["counts"]["forwards"]
        steps = probes["decode"]["counts"]["decode_steps"]
        want_l = {"prefill": {"flash_attention_fwd_bf16": 32 * forwards},
                  "decode": {"ragged_paged_attention_bf16": 32 * steps},
                  "proxy": {}}
        for r, p in probes.items():
            for sym, n in p["launches"].items():
                if n != want_l[r].get(sym, 0):
                    fail(f"15e: {sym} launched {n} times in the {r} "
                         f"replica, expected {want_l[r].get(sym, 0)} "
                         f"({forwards} prefill forwards, {steps} decode "
                         f"steps)")
        if probes["decode"]["counts"]["prefills"]:
            fail(f"15e: the decode engine ran "
                 f"{probes['decode']['counts']['prefills']} prefills")
        if probes["proxy"]["cuda_initialized"]:
            fail("15e: the PD proxy replica holds a CUDA context")
        out["launches"] = {
            sym: probes["prefill"]["launches"][sym]
            + probes["decode"]["launches"][sym]
            for sym in probes["prefill"]["launches"]}
        out["15e"] = {"launches_by_replica": {r: p["launches"]
                                              for r, p in probes.items()},
                      "prefill_forwards": forwards,
                      "prefill_jobs": probes["prefill"]["counts"]["jobs"],
                      "decode_steps": steps}

        # 15f: the halves of TTFT, and the plane's pages and GB/s
        transfers = probes["decode"]["transfers"]
        moved = sum(t["bytes"] for t in transfers)
        pd_rows = sorted((r for r in rows("pd_proxy") if r["status"] == 200),
                         key=lambda r: r["ts"])[:len(prompts)]
        out["15f"] = {
            "prefill_ttft_s": out["15b"]["ttft_s"],
            "decode_first_token_s": [r["phases"]["decode_first_token"]
                                     for r in pd_rows],
            "transfers": len(transfers),
            "pages": sum(t["pages"] for t in transfers),
            "bytes": moved,
            "plane_GBps": moved / max(sum(t["s"] for t in transfers), 1e-9)
            / 1e9}
        serve.shutdown()
        left = {p for g in segs for p in glob.glob(g)} - before
        if left:
            fail(f"15g: after serve.shutdown() shm segments are left: "
                 f"{sorted(left)}")
    finally:
        rt.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        RayConfig.reset()
    # 15g: nothing of the session is left
    left = ({p for g in segs for p in glob.glob(g)} - before) | set(
        glob.glob(f"/dev/shm/rtpt_{sid}*"))
    if left:
        fail(f"15g: shm segments of the session left: {sorted(left)}")
    out["phase_s"] = time.perf_counter() - t_phase
    a, b, c, f = out["15a"], out["15b"], out["15c"], out["15f"]
    c14 = phase14["14c"]

    def ms(xs):  # the cold first request, then the median of the rest
        warm = sorted(xs[1:])
        return f"{xs[0] * 1e3:.3f} first, {warm[len(warm) // 2] * 1e3:.3f}"
    print(f"serve PD over HTTP on {card}: serve.run to the first probe "
          f"passed {', '.join(f'{n} {s:.3f}' for n, s in a['serve_run_to_first_probe_passed_s'].items())} s; "
          f"sequential latency {min(b['latency_s']):.3f}-"
          f"{max(b['latency_s']):.3f} s (phase 14 "
          f"{min(phase14['14b']['latency_s']):.3f}-"
          f"{max(phase14['14b']['latency_s']):.3f}), TTFT halves prefill "
          f"{ms(f['prefill_ttft_s'])} ms, decode first token "
          f"{ms(f['decode_first_token_s'])} ms (warm medians); "
          f"concurrent {min(c['latency_s']):.3f}-{max(c['latency_s']):.3f} "
          f"s, {c['tokens_per_s']:.1f} tokens/s (phase 14 "
          f"{c14['tokens_per_s']:.1f}); lone SSE TTFT "
          f"{c['lone_stream_ttft_s'] * 1e3:.3f} ms (phase 14 "
          f"{c14['lone_stream_ttft_s'] * 1e3:.3f}); plane {f['pages']} pages, "
          f"{f['plane_GBps']:.3f} GB/s; drop reclaimed in "
          f"{c['drop_to_reclaimed_s']:.3f} s; phase 15 took "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------- phase 16

BATCH_ENV = {
    # the processor's engine actor asks for no GPU, as in the JAX package:
    # it reaches the card as the PD pools do
    "RAY_TPU_TORCH_WORKER_PLATFORM": "cuda",
    # 16b keeps ~6 GB of blocks in the store: inputs, their union, the GPU
    # stage's f32 outputs and their materialized copy
    "RAY_TPU_TORCH_STORE_CAPACITY": str(12 << 30)}
BATCH_ROWS = 64                 # 16a's JSONL rows
BATCH_SIZE = 16                 # 16a's processor batch
IMG_SHAPE = (224, 224, 3)       # 16b's uint8 image rows
IMG_BATCH = 256
IMG_BATCHES = 4                 # cut from 16 to 8 for phase 23, to 4 for 20c
IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)
NORM_TOL = 1e-6                 # the card's f32 normalization vs numpy's


def batch_texts() -> list[str]:
    """16a's 64 JSONL prompts: printable ASCII whose byte tokens (with BOS)
    have lengths drawn from phase 4's mix."""
    import numpy as np

    rng = np.random.default_rng(SEED + 16)
    lengths = rng.choice(SERVE_LENGTHS, size=BATCH_ROWS)
    return ["".join(chr(c) for c in rng.integers(32, 127, size=n - 1))
            for n in lengths]


def batch_sampling() -> dict:
    """The processor's sampling: phase 14's (greedy, 16 tokens, the byte
    EOS as stop token)."""
    from ray_tpu_torch.llm import ByteTokenizer

    return {"max_tokens": HTTP_MAX_TOKENS, "temperature": 0.0,
            "stop_token_ids": (ByteTokenizer().eos_token_id,)}


def batch_expected(torch, cfg, params) -> list[list[int]]:
    """The ids of 16a's 64 rows from an in-process LLMEngine on phase 10's
    weights with phase 4's engine options, fed as the processor feeds its
    actor: each batch of BATCH_SIZE rows submitted together (the scheduler
    held until all are in), one batch after the other. Run while phase
    10's model is alive."""
    from ray_tpu_torch.llm import ByteTokenizer, LLMConfig, LLMEngine
    from ray_tpu_torch.llm import SamplingParams

    built = LLMConfig(engine_kwargs=http_engine_kwargs())
    built.build_model = lambda device=None: (cfg, params)
    tok = ByteTokenizer()
    sp = SamplingParams(**batch_sampling())
    texts = batch_texts()
    eng = LLMEngine.from_config(built)
    out = []
    try:
        for i in range(0, len(texts), BATCH_SIZE):
            gate = hold_admission(eng)
            reqs = [eng.submit(tok.encode(t), sp)
                    for t in texts[i:i + BATCH_SIZE]]
            gate.set()
            out += [list(r) for r in reqs]
    finally:
        eng.shutdown()
    return out


def batch_probe(base, prepare=None):
    """The processor's engine actor class with probes, for 16a: when its
    process started, when CUDA was ready and when the model was built; the
    prompt and generated ids of every request, read in the actor as its
    generate_batch consumes them; its launch counts, engine stats and
    weight fingerprints. Defined here, so nothing is added to the
    package; pickled by value into the actor."""

    class Tap:
        """A request's token queue that records what its reader takes."""

        def __init__(self, q, rec, done, error):
            self.q, self.rec, self.done, self.error = q, rec, done, error

        def put(self, x):
            self.q.put(x)

        def get(self, *a, **kw):
            x = self.q.get(*a, **kw)
            if x is not self.done and not isinstance(x, self.error):
                self.rec.append(int(x))  # a token id
            return x

    class ProbeWorker(base):
        def __init__(self, blob):
            import os
            import time

            t_enter = time.time()
            started = process_start_time()
            if prepare is not None:
                prepare()
            import torch

            torch.empty(1, device=torch.device("cuda"))
            torch.cuda.synchronize()
            t_cuda = time.time()
            super().__init__(blob)
            torch.cuda.synchronize()
            self.probe = {"process_start": started, "init_enter": t_enter,
                          "cuda_ready": t_cuda, "model_built": time.time(),
                          "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                          "device_count": torch.cuda.device_count(),
                          "pid": os.getpid(),
                          "error": None if self.error is None
                          else repr(self.error)}
            self.records: list = []
            if self.error is None:
                from ray_tpu_torch.llm import engine as eng_mod

                submit = self.engine.submit

                def recorded(ids, params=None, **kw):
                    req = submit(ids, params, **kw)
                    rec = {"prompt": list(ids), "ids": []}
                    self.records.append(rec)
                    req.out_queue = Tap(req.out_queue, rec["ids"],
                                        eng_mod._SENTINEL,
                                        eng_mod._EngineError)
                    return req

                self.engine.submit = recorded

        def probe_state(self, zero_counts: bool = False) -> dict:
            from ray_tpu_torch.ops import flash_attention as fa
            from ray_tpu_torch.ops import ragged_paged_attention as ra

            kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ, ra.KERNEL]
            out = {"launches": {k.symbol: k.launches for k in kernels},
                   "stats": self.engine.stats() if self.error is None
                   else {}, "records": list(self.records), **self.probe,
                   "n_layers": self.engine.cfg.n_layers
                   if self.error is None else None}
            if zero_counts:
                for k in kernels:
                    k.launches = 0
                self.records.clear()
            return out

        def probe_fingerprints(self) -> dict:
            import torch

            return weight_fingerprints(torch, self.engine.params)

    return ProbeWorker


def batch_launch_gate(where: str, probe: dict, stats0: dict) -> dict:
    """The launches counted in the actor since its counts were zeroed must
    be 32 flash forwards a prefill and 32 ragged decodes a decode step, and
    no backward; returns the prefill and step counts."""
    st = probe["stats"]
    prefills = st["prefills"] - stats0["prefills"]
    steps = st["decode_steps"] - stats0["decode_steps"]
    L = probe["n_layers"]
    want = {"flash_attention_fwd_bf16": L * prefills,
            "ragged_paged_attention_bf16": L * steps}
    for sym, n in probe["launches"].items():
        if n != want.get(sym, 0):
            fail(f"{where}: {sym} launched {n} times in the actor, expected "
                 f"{want.get(sym, 0)} ({prefills} prefills, {steps} decode "
                 f"steps)")
    if not prefills or not steps:
        fail(f"{where}: the actor ran {prefills} prefills and {steps} decode "
             f"steps")
    return {"prefills": prefills, "decode_steps": steps}


def batch_llm(torch, rt, card: str, phase4: dict, expected14: list[dict],
              expected16: list[list[int]], prepare=None) -> dict:
    """16a: build_llm_processor on Llama-3-8B over Data, in a session
    whose workers see the card. 16a.1 phase 14's prompts at batch_size 1,
    token-exact to in-process serving; 16a.2 read_json → map(preprocess)
    → the processor (batch_size 16) → map(postprocess) → write_json, read
    back; 16a.3 times and launches. Returns with the processor shut down
    and the session still up (16b runs in it)."""
    import json
    import tempfile

    from ray_tpu_torch import data as rd
    from ray_tpu_torch.llm import (ByteTokenizer, LLMConfig,
                                   ModelLoadingConfig, build_llm_processor)
    from ray_tpu_torch.llm import batch as llm_batch
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ragged_paged_attention as ra

    driver_kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ, ra.KERNEL]
    zero(driver_kernels)
    tok = ByteTokenizer()
    out = {}

    def preprocess(row):
        return {**row, "prompt": row["text"]}

    def postprocess(row):
        return {**row, "generated_bytes": len(row["generated"].encode())}

    cfg = LLMConfig(model_loading_config=ModelLoadingConfig(model_id="8b"),
                    model_family="llama", engine_kwargs=http_engine_kwargs())
    real_worker = llm_batch._EngineWorker
    llm_batch._EngineWorker = rt.remote(batch_probe(real_worker._cls,
                                                    prepare))
    try:
        proc = build_llm_processor(
            cfg, preprocess=preprocess, postprocess=postprocess,
            concurrency=1, batch_size=1, sampling_params=batch_sampling())
        t_boot = time.time()
        (actor,) = proc._pool()
    finally:
        llm_batch._EngineWorker = real_worker
    try:
        probe = rt.get(actor.probe_state.remote(True), timeout=900)
        ready_s = time.time() - t_boot
        if probe["error"] is not None:
            fail(f"16a: the engine actor has no engine: {probe['error']}")
        if probe["device_count"] != 1 or probe["n_layers"] != 32:
            fail(f"16a: the actor sees {probe['device_count']} devices and "
                 f"serves {probe['n_layers']} layers")
        fps = rt.get(actor.probe_fingerprints.remote(), timeout=120)
        if fps != phase4["fingerprints"]:
            fail(f"16a: the actor's weights differ from phase 4's: {fps}")
        out["ready"] = {
            "processor_to_ready_s": ready_s,
            # negative: the pool had started the worker before the call
            "actor_process_start_s": probe["process_start"] - t_boot,
            "process_to_init_s": probe["init_enter"] - probe["process_start"],
            "cuda_context_s": probe["cuda_ready"] - probe["init_enter"],
            "model_build_s": probe["model_built"] - probe["cuda_ready"],
            "actor_visible": probe["visible"]}

        # 16a.1: phase 14's prompts alone, token-exact to in-process serving
        stats0 = probe["stats"]
        texts14 = http_prompts()
        rows = proc(rd.from_items([{"id": i, "text": t} for i, t in
                                   enumerate(texts14)])).take_all()
        probe = rt.get(actor.probe_state.remote(True), timeout=120)
        got = [r["ids"] for r in probe["records"]]
        want = [w["ids"] for w in expected14]
        if got != want:
            diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            fail(f"16a.1: ids read in the actor differ from in-process "
                 f"serving for prompts {diff} (of {len(got)} / {len(want)})")
        texts = [r["generated"] for r in sorted(rows, key=lambda r: r["id"])]
        if texts != [w["text"] for w in expected14]:
            fail("16a.1: the processor's text differs from in-process "
                 "serving's")
        out["16a1"] = {"rows": len(rows), "token_exact": True,
                       **batch_launch_gate("16a.1", probe, stats0)}

        # 16a.2: the JSONL pipeline through the processor at batch 16
        stats0 = probe["stats"]
        texts = batch_texts()
        work = tempfile.mkdtemp(prefix="chip_smoke_batch_")
        src, dst = os.path.join(work, "in"), os.path.join(work, "out")
        os.makedirs(src)
        with open(os.path.join(src, "prompts.jsonl"), "w") as f:
            for i, t in enumerate(texts):
                f.write(json.dumps({"id": i, "text": t}) + "\n")
        proc.batch_size = BATCH_SIZE
        t0 = time.perf_counter()
        files = proc(rd.read_json(src)).write_json(dst)
        pipeline_s = time.perf_counter() - t0
        probe = rt.get(actor.probe_state.remote(True), timeout=120)
        back = sorted(rd.read_json(dst).take_all(), key=lambda r: r["id"])
        if [r["id"] for r in back] != list(range(BATCH_ROWS)):
            fail(f"16a.2: {len(back)} rows came back, ids "
                 f"{[r['id'] for r in back][:8]}...")
        by_prompt = {tuple(r["prompt"]): r["ids"] for r in probe["records"]}
        if len(probe["records"]) != BATCH_ROWS:
            fail(f"16a.2: the actor served {len(probe['records'])} requests")
        for r in back:
            ids = by_prompt.get(tuple(tok.encode(r["text"])))
            if (r["text"] != texts[r["id"]] or r["prompt"] != r["text"]
                    or ids is None or not ids
                    or r["generated"] != tok.decode(ids)
                    or r["generated_bytes"] != len(
                        r["generated"].encode())):
                fail(f"16a.2: row {r['id']} came back altered: "
                     f"{ {k: str(v)[:40] for k, v in r.items()} }")
        ids = [by_prompt[tuple(tok.encode(t))] for t in texts]
        generated = sum(len(i) for i in ids)
        out["16a2"] = {
            "rows": len(back), "files": len(files),
            "pipeline_s": pipeline_s,
            "rows_per_s": BATCH_ROWS / pipeline_s,
            "generated_tokens": generated,
            "generated_tokens_per_s": generated / pipeline_s,
            "rows_equal_in_process": sum(a == b for a, b in
                                         zip(ids, expected16)),
            "rows_with_text": sum(bool(r["generated"]) for r in back),
            **batch_launch_gate("16a.2", probe, stats0)}
        out["launches"] = probe["launches"]
        driver = counts(driver_kernels)
        if any(driver.values()):
            fail(f"16a: kernels launched in the driver: {driver}")
        out["driver_launches"] = driver
    finally:
        proc.shutdown()
    return out


def data_to_card(torch, rt, card: str, prepare=None) -> dict:
    """16b: ~0.3 GB of uint8 image rows from a numpy seed through
    from_numpy, normalized on the card by a num_gpus=1 callable-class
    stage (checked in its worker against numpy), then delivered to the
    driver's card by iter_device_batches and held byte-exact to the host
    batches."""
    import numpy as np

    from ray_tpu_torch import data as rd

    n = IMG_BATCH * IMG_BATCHES
    rng = np.random.default_rng(SEED + 16)
    images = np.frombuffer(rng.bytes(n * int(np.prod(IMG_SHAPE))),
                           np.uint8).reshape(n, *IMG_SHAPE)
    parts = [rd.from_numpy(images[i:i + IMG_BATCH])
             for i in range(0, n, IMG_BATCH)]
    ds = parts[0].union(*parts[1:])

    class Normalize:
        """ImageNet normalization on the card; each batch also in numpy
        f32, and the largest difference returned beside it."""

        def __init__(self):
            import os as _os
            import time as _time

            t0 = _time.perf_counter()
            if prepare is not None:
                prepare()
            import torch as _torch

            self.torch = _torch
            self.dev = _torch.device("cuda")
            self.mean = _torch.tensor(IMG_MEAN, device=self.dev)
            self.std = _torch.tensor(IMG_STD, device=self.dev)
            self.devices = _torch.cuda.device_count()
            vis = _os.environ.get("CUDA_VISIBLE_DEVICES", "")
            self.visible = int(vis) if vis.isdigit() else -1
            self.init_s = _time.perf_counter() - t0  # torch + CUDA context

        def __call__(self, batch):
            import time as _time

            import numpy as _np

            x = batch["data"]
            t0 = _time.perf_counter()
            t = self.torch.from_numpy(x.copy()).to(self.dev)
            y = ((t.float() / 255.0 - self.mean) / self.std).cpu().numpy()
            t1 = _time.perf_counter()
            want = ((x.astype(_np.float32) / _np.float32(255.0)
                     - _np.asarray(IMG_MEAN, _np.float32))
                    / _np.asarray(IMG_STD, _np.float32))
            err = _np.abs(y - want).max()
            t2 = _time.perf_counter()
            k = len(x)
            return {"image": y, "max_err": _np.full(k, err, _np.float32),
                    "devices": _np.full(k, self.devices),
                    "visible": _np.full(k, self.visible),
                    "init_s": _np.full(k, self.init_s),
                    "gpu_ms": _np.full(k, (t1 - t0) * 1e3),
                    "check_ms": _np.full(k, (t2 - t1) * 1e3)}

    t0 = time.perf_counter()
    mat = ds.map_batches(Normalize, batch_size=IMG_BATCH, num_gpus=1,
                         concurrency=1, compute="actors").materialize()
    stage_s = time.perf_counter() - t0
    host = list(mat.iter_batches(batch_size=IMG_BATCH, drop_last=True))
    if len(host) != IMG_BATCHES:
        fail(f"16b: {len(host)} host batches of {IMG_BATCH}")
    devices = {int(d) for b in host for d in b["devices"]}
    visible = {int(v) for b in host for v in b["visible"]}
    err = max(float(b["max_err"].max()) for b in host)
    if devices != {1} or -1 in visible:
        fail(f"16b: the GPU stage's worker saw {devices} devices, "
             f"CUDA_VISIBLE_DEVICES {visible}")
    if not err <= NORM_TOL:
        fail(f"16b: the card's normalization is {err} from numpy's "
             f"(tolerance {NORM_TOL})")
    rows = images[3 * IMG_BATCH:3 * IMG_BATCH + 4]
    want = ((rows.astype(np.float32) / np.float32(255.0)
             - np.asarray(IMG_MEAN, np.float32))
            / np.asarray(IMG_STD, np.float32))
    if np.abs(host[3]["image"][:4] - want).max() > NORM_TOL:
        fail("16b: the stage's output rows are not their inputs'")

    # the device iterator, timed twice: the first pass meets the store's
    # pages and the pinned staging buffers cold, the second warm; each
    # batch held byte-exact to its host batch on the card
    cols = ("image", "max_err", "devices", "visible", "gpu_ms", "check_ms")
    passes = []
    for p in ("cold", "warm"):
        torch.cuda.synchronize()
        waits, got = [], []
        t0 = time.perf_counter()
        it = mat.iter_device_batches(batch_size=IMG_BATCH,
                                     device="cuda", prefetch=2)
        while True:
            tw = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                break
            waits.append(time.perf_counter() - tw)
            got.append(b)
        torch.cuda.synchronize()
        iter_s = time.perf_counter() - t0
        if len(got) != IMG_BATCHES:
            fail(f"16b: iter_device_batches gave {len(got)} batches")
        for i, (g, h) in enumerate(zip(got, host)):
            for col in cols:
                t = g[col]
                if t.device.type != "cuda":
                    fail(f"16b: batch {i} column {col} is on {t.device}")
                if not torch.equal(t, torch.from_numpy(
                        np.ascontiguousarray(h[col])).to(t.device)):
                    fail(f"16b: batch {i} column {col} is not byte-exact")
        nbytes = sum(t.numel() * t.element_size() for g in got
                     for t in g.values())
        w = sorted(waits)
        passes.append({"pass": p, "s": iter_s, "bytes": nbytes,
                       "GBps": nbytes / iter_s / 1e9,
                       "wait_ms": {"first": waits[0] * 1e3,
                                   "median": w[len(w) // 2] * 1e3,
                                   "max": w[-1] * 1e3}})
        del got
        torch.cuda.empty_cache()
    # the plain synchronous copy of the same host batches, for scale
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for h in host:
        for col in cols:
            torch.from_numpy(np.ascontiguousarray(h[col])).to(
                torch.device("cuda"))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return {"rows": n, "input_bytes": images.nbytes,
            "stage_s": stage_s, "stage_rows_per_s": n / stage_s,
            "stage_worker_init_s": float(host[0]["init_s"][0]),
            "stage_gpu_s": sum(float(b["gpu_ms"][0]) for b in host) / 1e3,
            "stage_numpy_check_s": sum(float(b["check_ms"][0])
                                       for b in host) / 1e3,
            "max_err_vs_numpy": err, "stage_devices": sorted(devices),
            "stage_visible": sorted(visible), "iter": passes,
            "plain_copy_s": plain_s,
            "plain_copy_GBps": passes[-1]["bytes"] / plain_s / 1e9}


def batch_phase(torch, rt, card: str, phase4: dict, expected14: list[dict],
                expected16: list[list[int]], prepare=None) -> dict:
    """Phase 16 in a fresh session with BATCH_ENV: 16a, then 16b; after
    shutdown() no segment of the session is left."""
    import glob

    from ray_tpu_torch._private.ray_config import RayConfig

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in BATCH_ENV}
    os.environ.update(BATCH_ENV)
    RayConfig.reset()
    out = {}
    try:
        info = rt.init(num_cpus=8)
        sid = out["session"] = info["session_id"]
        out["16a"] = batch_llm(torch, rt, card, phase4, expected14,
                               expected16, prepare)
        out["16b"] = data_to_card(torch, rt, card, prepare)
    finally:
        rt.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        RayConfig.reset()
    left = glob.glob(f"/dev/shm/rtpt_{sid}*")
    if left:
        fail(f"16: shm segments of the session left: {sorted(left)}")
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = out["16a"]["launches"]
    a, b = out["16a"], out["16b"]
    print(f"batch inference on {card}: processor to ready "
          f"{a['ready']['processor_to_ready_s']:.3f} s; 16a.1 token-exact "
          f"({a['16a1']['rows']} prompts alone); pipeline of "
          f"{a['16a2']['rows']} rows in {a['16a2']['pipeline_s']:.3f} s, "
          f"{a['16a2']['rows_per_s']:.3f} rows/s, "
          f"{a['16a2']['generated_tokens_per_s']:.1f} generated tokens/s, "
          f"{a['16a2']['rows_equal_in_process']} of {BATCH_ROWS} rows equal "
          f"in-process; 16b GPU stage {b['stage_rows_per_s']:.1f} rows/s "
          f"(max err {b['max_err_vs_numpy']:.3g}), iter_device_batches "
          f"cold {b['iter'][0]['GBps']:.3f}, warm {b['iter'][1]['GBps']:.3f}"
          f" GB/s (plain copy {b['plain_copy_GBps']:.3f}), warm wait per "
          f"batch median {b['iter'][1]['wait_ms']['median']:.3f} ms; phase "
          f"16 took {out['phase_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------- phase 17

TRAIN_ENV = {
    # 17c's and 17d's workers hold a 0.5 GPU share, which binds no card:
    # they reach it as the PD pools do
    "RAY_TPU_TORCH_WORKER_PLATFORM": "cuda",
    # 17c's ring puts GPT-2's 0.5 GB f32 vector through the store each step
    "RAY_TPU_TORCH_STORE_CAPACITY": str(8 << 30)}
TRAIN_LR, TRAIN_WD = 1e-4, 0.01          # phase 6's adamw
T17_BATCH, T17_STEPS = 4, 4              # 17a: Llama-3.2-1B, 4 x 2048
# 17b: 4 steps, killed in step 3 (cut from 8 and 5 to make room for 20c:
# one checkpoint before the kill and one after it, as before). Keeping 1
# (was 2) so that the 2 checkpoints still drive retention: step 4's
# commit deletes step 2's, the one the second attempt restored
GPT2_BATCH, GPT2_SEQ, GPT2_STEPS = 8, 1024, 4
KILL_STEP, CKPT_EVERY, CKPT_KEEP = 3, 2, 1
ZERO_STEPS = 2                           # 17c: cut from 3 for 20c
# (kind, gradient compression, rate): f32 at tests/test_zero.py's rate;
# int8 at phase 6's. On random tokens GPT-2 diverges at 1e-2 (f32 loss up
# ~1.8 in 3 steps), and the two int8 runs then diverge apart (sharded 38.5
# against unsharded 14.8, PERF.md §6): loss parity there compares noise
ZERO_RUNS = (("fp32", None, 1e-2), ("int8", "int8_block", TRAIN_LR))
TUNE_STEPS, TUNE_LRS = 2, (1e-4, 1e-3)   # 17d: steps cut from 3 for 20c


def gpt2_train_config():
    from ray_tpu_torch.models import gpt2

    return gpt2.gpt2_config("124m")


def gpt2_batch(k: int, vocab: int):
    """17b's batch of step k (1-based): [8, 1025] token ids from numpy seed
    SEED + k, so a resumed attempt sees the batches an uninterrupted run
    does."""
    import numpy as np

    return np.random.default_rng(SEED + k).integers(
        0, vocab, size=(GPT2_BATCH, GPT2_SEQ + 1))


def loop_kernels():
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ragged_paged_attention as ra

    return [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ, ra.KERNEL]


def train_launches(cfg, steps: int) -> dict:
    """Phase 6's formula: the forward and its recompute under remat, one
    dK/dV and one dQ per layer and step, no decode."""
    L = cfg.n_layers
    return {"flash_attention_fwd_bf16": 2 * L * steps,
            "flash_attention_bwd_dkv_bf16": L * steps,
            "flash_attention_bwd_dq_bf16": L * steps,
            "ragged_paged_attention_bf16": 0}


def rows_sha(rows) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(rows).tobytes()).hexdigest()


def train_model(torch, cfg, lr: float = TRAIN_LR, marks=None):
    """(params, optimizer, step) on the card from seed SEED, as phase 6;
    `marks` gets the wall time after the imports and after the params."""
    from ray_tpu_torch import train as tr
    from ray_tpu_torch.models import transformer

    dev = torch.device("cuda")
    if marks is not None:
        marks["imported"] = time.time()
    params = transformer.init(
        torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    if marks is not None:
        torch.cuda.synchronize()
        marks["params"] = time.time()
    opt = tr.adamw(params, lr, weight_decay=TRAIN_WD)
    step = tr.make_train_step(
        lambda p, b: transformer.loss_fn(p, b, cfg), opt)
    return params, opt, step


def run_steps(torch, step, params, batches, on_step=None) -> list[float]:
    """Each batch (numpy rows) to the card and one step; the loss read back
    (a sync). ``on_step(i, rows, loss, ms)`` after each."""
    losses = []
    for i, rows in enumerate(batches):
        t0 = time.perf_counter()
        tokens = torch.as_tensor(rows, device=torch.device("cuda"))
        params, _, loss = step(params, None, tokens)
        losses.append(loss.item())
        if on_step is not None:
            on_step(i, rows, losses[-1], (time.perf_counter() - t0) * 1e3)
    return losses


def llama_loop(config):
    """17a's train loop: Llama-3.2-1B (phase 6's config) on the rows of the
    "train" dataset shard, 4 at a time; every step reports its loss, time
    and the batch's hash, the last also the worker's start-up times and its
    launch counts."""
    t_enter = time.time()
    started = process_start_time()
    if config.get("prepare") is not None:
        config["prepare"]()
    import numpy as np
    import torch

    torch.empty(1, device=torch.device("cuda"))
    torch.cuda.synchronize()
    t_cuda = time.time()
    from ray_tpu_torch import train as tr

    cfg = train_config()
    marks = {}
    params, _, step = train_model(torch, cfg, marks=marks)
    torch.cuda.synchronize()
    t_built = time.time()
    kernels = loop_kernels()
    zero(kernels)
    losses = []

    def on_step(i, rows, loss, ms):
        losses.append(loss)
        m = {"loss": loss, "step_ms": ms, "batch_sha": rows_sha(rows)}
        if i + 1 == config["steps"]:
            m.update(launches=counts(kernels), losses=list(losses),
                     process_start=started, loop_enter=t_enter,
                     cuda_ready=t_cuda, model_built=t_built,
                     imported=marks["imported"], params_drawn=marks["params"],
                     device=torch.cuda.get_device_name(0))
        tr.report(m)

    shard = tr.get_dataset_shard("train")
    run_steps(torch, step, params,
              (np.ascontiguousarray(b["data"])
               for b in shard.iter_batches(batch_size=config["batch"])),
              on_step)


def gpt2_resume_loop(config):
    """17b's train loop: GPT-2 124M, step k on ``gpt2_batch(k)``, a
    checkpoint (params and AdamW state, ``torch.save``) every CKPT_EVERY
    steps. On an attempt that starts from no checkpoint the process
    SIGKILLs itself in step KILL_STEP, after its backward and before its
    report; an attempt that starts from one restores it and carries on."""
    import os
    import shutil
    import signal
    import tempfile

    if config.get("prepare") is not None:
        config["prepare"]()
    import torch

    from ray_tpu_torch import train as tr
    from ray_tpu_torch.train.optim import param_leaves

    cfg = gpt2_train_config()
    t_enter = time.time()
    params, opt, step = train_model(torch, cfg)
    torch.cuda.synchronize()
    t_built = time.time()
    kernels = loop_kernels()
    zero(kernels)
    ckpt = tr.get_checkpoint()
    start, restore = 0, None
    if ckpt is not None:
        t0 = time.perf_counter()
        with ckpt.as_directory() as d:
            path = os.path.join(d, "rank_0", "state.pt")
            nbytes = os.path.getsize(path)
            state = torch.load(path, map_location=torch.device("cuda"))
        with torch.no_grad():
            for p, q in zip(param_leaves(params),
                            param_leaves(state["params"])):
                p.copy_(q)
        opt.load_state_dict(state["opt"])
        start = state["step"]
        del state
        torch.cuda.synchronize()
        restore = {"s": time.perf_counter() - t0, "bytes": nbytes,
                   "step": start, "t_first_step": None,
                   "process_start": process_start_time(),
                   "loop_enter": t_enter, "model_built": t_built}
    losses, saves = {}, []
    for k in range(start + 1, config["steps"] + 1):
        t0 = time.perf_counter()
        tokens = torch.as_tensor(gpt2_batch(k, cfg.vocab_size),
                                 device=torch.device("cuda"))
        params, _, loss = step(params, None, tokens)
        losses[k] = loss.item()
        if restore is not None and restore["t_first_step"] is None:
            restore["t_first_step"] = time.time()
        if k == KILL_STEP and ckpt is None:
            with open(config["kill_mark"], "w") as f:
                f.write(repr(time.time()))
            os.kill(os.getpid(), signal.SIGKILL)
        m = {"step": k, "loss": losses[k],
             "step_ms": (time.perf_counter() - t0) * 1e3}
        if k == config["steps"]:
            m.update(losses=dict(losses), restore=restore, saves=saves,
                     launches=counts(kernels))
        if k % CKPT_EVERY:
            tr.report(m)
            continue
        d = tempfile.mkdtemp(dir=config["scratch"])
        try:
            t1 = time.perf_counter()
            torch.save({"params": params, "opt": opt.state_dict(),
                        "step": k}, os.path.join(d, "state.pt"))
            nbytes = os.path.getsize(os.path.join(d, "state.pt"))
            t2 = time.perf_counter()
            saves.append({"step": k, "bytes": nbytes, "save_s": t2 - t1})
            tr.report(m, checkpoint=tr.Checkpoint.from_directory(d))
            saves[-1]["persist_s"] = time.perf_counter() - t2
        finally:
            shutil.rmtree(d, ignore_errors=True)


def zero_loop(config):
    """17c's train loop, one of two ranks sharing the card: for each of
    ZERO_RUNS, GPT-2 124M from seed SEED on its half of 17b's batch k,
    ``ZeroShardedOptimizer`` over the host ring. After each run a rank
    writes its params' hash, losses, opt-state gauge, the ring's bytes and
    its launches to ``<out>/<kind>_rank<r>.json``, rank 0 its final params
    to ``<out>/<kind>_params.pt``."""
    import functools
    import hashlib
    import os

    if config.get("prepare") is not None:
        config["prepare"]()
    import torch

    from ray_tpu_torch import train as tr
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.train.optim import param_leaves
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util import metrics as met

    rank = tr.get_context().get_world_rank()
    cfg = gpt2_train_config()
    dev = torch.device("cuda")
    kernels = loop_kernels()
    half = GPT2_BATCH // 2
    for kind, compression, lr in ZERO_RUNS:
        group = f"{config['group']}_{kind}"
        col.init_collective_group(2, rank, group_name=group)
        params = transformer.init(
            torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
        make = tr.adamw if kind == "fp32" else tr.adamw_int8
        zopt = tr.ZeroShardedOptimizer(
            functools.partial(make, learning_rate=lr, weight_decay=TRAIN_WD),
            group_name=group, grad_compression=compression, name=kind)
        state = zopt.init(params)
        zero(kernels)
        losses, ring_ms = [], []
        for k in range(1, ZERO_STEPS + 1):
            rows = gpt2_batch(k, cfg.vocab_size)[rank * half:
                                                 (rank + 1) * half]
            leaves = [t.requires_grad_(True) for t in param_leaves(params)]
            loss = transformer.loss_fn(
                params, torch.as_tensor(rows, device=dev), cfg)
            grads = dict(enumerate(torch.autograd.grad(loss, leaves)))
            losses.append(loss.item())
            t0 = time.perf_counter()
            params, state = zopt.step(params, grads, state)
            torch.cuda.synchronize()
            ring_ms.append((time.perf_counter() - t0) * 1e3)
            tr.report({"kind": kind, "loss": losses[-1],
                       "ring_ms": ring_ms[-1]})
        launches = counts(kernels)
        flat = torch.cat([t.detach().reshape(-1).float().cpu()
                          for t in param_leaves(params)])
        snap = met.snapshot()

        def series(name):
            return [s for m in snap if m["name"] == name
                    for s in m["series"]]

        out = {"rank": rank, "losses": losses, "ring_ms": ring_ms,
               "params_sha": hashlib.sha256(flat.numpy().tobytes())
               .hexdigest(),
               "state_bytes": zopt.state_bytes(state),
               "gauge": series("ray_tpu_train_opt_state_bytes"),
               "coll_bytes": series("ray_tpu_collective_bytes_total"),
               "launches": launches}
        with open(os.path.join(config["out"], f"{kind}_rank{rank}.json"),
                  "w") as f:
            json.dump(out, f)
        if rank == 0:
            torch.save(flat, os.path.join(config["out"],
                                          f"{kind}_params.pt"))
        col.destroy_collective_group(group)
        del params, state, zopt, grads, leaves


def tune_loop(config):
    """17d's train loop (one trial's worker): GPT-2 124M at the trial's
    rate on 17b's first TUNE_STEPS batches; the last report carries every
    loss and the launch counts."""
    if config.get("prepare") is not None:
        config["prepare"]()
    import torch

    from ray_tpu_torch import train as tr

    cfg = gpt2_train_config()
    params, _, step = train_model(torch, cfg, lr=config["lr"])
    kernels = loop_kernels()
    zero(kernels)
    losses = []

    def on_step(i, rows, loss, ms):
        losses.append(loss)
        m = {"loss": loss, "step_ms": ms}
        if i + 1 == TUNE_STEPS:
            m.update(losses=list(losses), launches=counts(kernels),
                     lr=config["lr"])
        tr.report(m)

    run_steps(torch, step, params,
              (gpt2_batch(k, cfg.vocab_size)
               for k in range(1, TUNE_STEPS + 1)), on_step)


def zero_baseline(torch, kind: str, lr: float) -> dict:
    """17c's unsharded baseline in process: one AdamW (or int8 AdamW) over
    every param, stepping with the mean of the two halves' gradients."""
    from ray_tpu_torch import train as tr
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.train.optim import param_leaves

    cfg = gpt2_train_config()
    dev = torch.device("cuda")
    params = transformer.init(
        torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    make = tr.adamw if kind == "fp32" else tr.adamw_int8
    opt = make(params, lr, weight_decay=TRAIN_WD)
    leaves = param_leaves(params)
    half = GPT2_BATCH // 2
    losses = []
    for k in range(1, ZERO_STEPS + 1):
        rows = gpt2_batch(k, cfg.vocab_size)
        pairs = []
        for r in range(2):
            loss = transformer.loss_fn(
                params, torch.as_tensor(rows[r * half:(r + 1) * half],
                                        device=dev), cfg)
            pairs.append((loss.item(), torch.autograd.grad(loss, leaves)))
        losses.append(pairs[0][0])
        for p, g0, g1 in zip(leaves, pairs[0][1], pairs[1][1]):
            p.grad = (g0 + g1) / 2
        opt.step()
        opt.zero_grad(set_to_none=True)
    flat = torch.cat([t.detach().reshape(-1).float().cpu() for t in leaves])
    return {"losses": losses, "state_bytes":
            tr.optimizer_state_bytes(opt), "flat": flat}


def committed_only(storage, exp_dir: str) -> list[str]:
    """The checkpoint dirs under `exp_dir`; fails unless every one of them
    is committed (manifest and commit marker on every rank)."""
    names = sorted(n for n in storage.list_subdirs(storage.LocalBackend(),
                                                   exp_dir)
                   if n.startswith("checkpoint_"))
    good = [os.path.basename(p) for p, _ in storage.list_committed_checkpoints(
        storage.LocalBackend(), exp_dir, 1)]
    if names != sorted(good):
        fail(f"17: {exp_dir} holds checkpoint dirs that are not committed: "
             f"{sorted(set(names) - set(good))}")
    return names


def train_fit_17a(torch, rt, kernels, card: str, root: str,
                  prepare=None) -> dict:
    """17a: the in-process run first (then freed), then the same loop in a
    TorchTrainer GPU worker on the same rows through a dataset shard."""
    import numpy as np

    from ray_tpu_torch import data
    from ray_tpu_torch import train as tr

    cfg = train_config()
    rows = np.random.default_rng(SEED + 17).integers(
        0, cfg.vocab_size, size=(T17_BATCH * T17_STEPS, 2049))
    batches = [rows[i * T17_BATCH:(i + 1) * T17_BATCH]
               for i in range(T17_STEPS)]
    params, opt, step = train_model(torch, cfg)
    ref_ms = []
    ref = run_steps(torch, step, params, batches,
                    lambda i, r, loss, ms: ref_ms.append(ms))
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    zero(kernels)
    t0 = time.time()
    result = tr.TorchTrainer(
        llama_loop,
        train_loop_config={"steps": T17_STEPS, "batch": T17_BATCH,
                           "prepare": prepare},
        scaling_config=tr.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=tr.RunConfig(storage_path=os.path.join(root, "17a")),
        datasets={"train": data.from_numpy(rows)}).fit()
    fit_s = time.time() - t0
    driver = counts(kernels)
    m = result.metrics
    out = {"fit_s": fit_s, "losses": m.get("losses"), "ref_losses": ref,
           "ref_step_ms": ref_ms, "launches": m.get(
               "launches"), "driver_launches": driver,
           "error": result.error}
    if result.error is not None:
        fail(f"17a: Result.error {result.error}")
    if any(driver.values()):
        fail(f"17a: the driver launched kernels during fit(): {driver}")
    if m.get("losses") != ref:
        fail(f"17a: the worker's losses {m.get('losses')} are not the "
             f"in-process run's {ref} bit for bit")
    if m.get("loss") != ref[-1]:
        fail(f"17a: Result.metrics loss {m.get('loss')} is not the last "
             f"step's {ref[-1]}")
    want = train_launches(cfg, T17_STEPS)
    if m.get("launches") != want:
        fail(f"17a: the worker launched {m.get('launches')}, expected "
             f"{want}")
    out["start"] = {"fit_to_process_s": m["process_start"] - t0,
                    "process_to_loop_s": m["loop_enter"] - m["process_start"],
                    "torch_cuda_s": m["cuda_ready"] - m["loop_enter"],
                    "model_build_s": m["model_built"] - m["cuda_ready"],
                    "model_imports_s": m["imported"] - m["cuda_ready"],
                    "params_s": m["params_drawn"] - m["imported"],
                    "optimizer_s": m["model_built"] - m["params_drawn"]}
    out["last_step_ms"] = m["step_ms"]
    print(f"17a llama-3.2-1b TorchTrainer on {card}: fit() {fit_s:.3f} s; "
          f"worker process started {out['start']['fit_to_process_s']:.3f} s "
          f"after fit(), loop entered {out['start']['process_to_loop_s']:.3f}"
          f" s later, torch + CUDA {out['start']['torch_cuda_s']:.3f} s, "
          f"model build {out['start']['model_build_s']:.3f} s (imports "
          f"{out['start']['model_imports_s']:.3f}, params "
          f"{out['start']['params_s']:.3f}, optimizer "
          f"{out['start']['optimizer_s']:.3f}); last step "
          f"{m['step_ms']:.3f} ms in the worker, {ref_ms[-1]:.3f} ms in "
          f"process; losses bit-equal {ref}", flush=True)
    return out


def train_resume_17b(torch, rt, kernels, card: str, root: str,
                     prepare=None) -> dict:
    """17b: an uninterrupted in-process run of the GPT2_STEPS steps, then
    the same loop under FailureConfig(max_failures=1), killed in step
    KILL_STEP and resumed from the checkpoint of the step before."""
    from ray_tpu_torch import train as tr
    from ray_tpu_torch.train import storage

    cfg = gpt2_train_config()
    params, opt, step = train_model(torch, cfg)
    ref = run_steps(torch, step, params,
                    (gpt2_batch(k, cfg.vocab_size)
                     for k in range(1, GPT2_STEPS + 1)))
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    scratch = os.path.join(root, "17b_scratch")
    os.makedirs(scratch)
    kill_mark = os.path.join(root, "17b_kill")
    exp = os.path.join(root, "17b")
    zero(kernels)
    t0 = time.time()
    result = tr.TorchTrainer(
        gpt2_resume_loop,
        train_loop_config={"steps": GPT2_STEPS, "scratch": scratch,
                           "kill_mark": kill_mark, "prepare": prepare},
        scaling_config=tr.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=tr.RunConfig(
            name="run", storage_path=exp,
            failure_config=tr.FailureConfig(max_failures=1),
            checkpoint_config=tr.CheckpointConfig(num_to_keep=CKPT_KEEP))
    ).fit()
    fit_s = time.time() - t0
    driver = counts(kernels)
    if any(driver.values()):
        fail(f"17b: the driver launched kernels during fit(): {driver}")
    m = result.metrics
    outcomes = [a["outcome"] for a in result.attempts]
    if outcomes != ["errored", "finished"]:
        fail(f"17b: attempts {result.attempts}")
    resumed = {int(k): v for k, v in (m.get("losses") or {}).items()}
    want = {k: ref[k - 1] for k in range(KILL_STEP, GPT2_STEPS + 1)}
    if resumed != want:
        fail(f"17b: the resumed losses {resumed} are not the uninterrupted "
             f"run's {want} bit for bit")
    restore = m.get("restore") or {}
    if restore.get("step") != KILL_STEP - 1:
        fail(f"17b: restored from step {restore.get('step')}, expected "
             f"{KILL_STEP - 1}")
    names = committed_only(storage, os.path.join(exp, "run"))
    last = f"checkpoint_{GPT2_STEPS - 1:06d}"
    # written: the one the second attempt restored, and its own saves
    written = int(restore.get("step") is not None) + len(m.get("saves") or [])
    if written <= CKPT_KEEP or len(names) != CKPT_KEEP or \
            names[-1] != last or result.checkpoint is None or \
            os.path.basename(result.checkpoint.path) != last:
        fail(f"17b: {written} checkpoints written, on disk {names}, "
             f"Result.checkpoint {getattr(result.checkpoint, 'path', None)};"
             f" expected more written than kept, and {CKPT_KEEP} kept with "
             f"the last {last}")
    if result.storage_retries != 0:
        fail(f"17b: storage_retries {result.storage_retries}")
    want_launches = train_launches(cfg, GPT2_STEPS - KILL_STEP + 1)
    if m.get("launches") != want_launches:
        fail(f"17b: the resumed worker launched {m.get('launches')}, "
             f"expected {want_launches}")
    with open(kill_mark) as f:
        t_kill = float(f.read())
    resume = {"to_process_s": restore["process_start"] - t_kill,
              "process_to_loop_s": restore["loop_enter"]
              - restore["process_start"],
              "model_build_s": restore["model_built"] - restore["loop_enter"],
              "restore_s": restore["s"]}
    saves = m.get("saves") or []
    out = {"fit_s": fit_s, "attempts": result.attempts, "losses": resumed,
           "ref_losses": ref, "checkpoints": names,
           "checkpoints_written": written,
           "kill_to_first_step_s": restore["t_first_step"] - t_kill,
           "restore_s": restore["s"], "restore_GBps":
           restore["bytes"] / restore["s"] / 1e9, "saves": saves,
           "launches": m["launches"], "driver_launches": driver,
           "resume_split": resume}
    gb = saves[-1]["bytes"] / 1e9 if saves else 0.0
    print(f"17b gpt2-124m kill and resume on {card}: fit() {fit_s:.3f} s; "
          f"kill to the resumed first step {out['kill_to_first_step_s']:.3f}"
          f" s (a new worker process {resume['to_process_s']:.3f} s after "
          f"the kill, its loop {resume['process_to_loop_s']:.3f} s later, "
          f"model build {resume['model_build_s']:.3f} s); checkpoint "
          f"{gb:.3f} GB, torch.save "
          f"{saves[-1]['save_s']:.3f} s, persist {saves[-1]['persist_s']:.3f}"
          f" s ({gb / saves[-1]['persist_s']:.3f} GB/s), restore "
          f"{restore['s']:.3f} s ({out['restore_GBps']:.3f} GB/s); steps "
          f"{KILL_STEP}-{GPT2_STEPS} bit-equal to the uninterrupted run; "
          f"{written} checkpoints written, {len(names)} kept",
          flush=True)
    return out


def train_zero_17c(torch, rt, kernels, card: str, root: str,
                   prepare=None) -> dict:
    """17c: 2 ranks sharing one H100, ZeRO-1 over the host ring in one
    fit(): f32 AdamW uncompressed, then int8 AdamW with int8 gradients,
    against unsharded in-process baselines (tests/test_zero.py's gates)."""
    from ray_tpu_torch import train as tr

    bases = {}
    for kind, _, lr in ZERO_RUNS:
        bases[kind] = zero_baseline(torch, kind, lr)
        gc.collect()
        torch.cuda.empty_cache()
    d = os.path.join(root, "17c")
    os.makedirs(d)
    zero(kernels)
    t0 = time.time()
    result = tr.TorchTrainer(
        zero_loop,
        train_loop_config={"out": d, "group": "z17", "prepare": prepare},
        scaling_config=tr.ScalingConfig(
            num_workers=2, resources_per_worker={"GPU": 0.5}),
        run_config=tr.RunConfig(storage_path=d)).fit()
    fit_s = time.time() - t0
    driver = counts(kernels)
    if any(driver.values()):
        fail(f"17c: the driver launched kernels during fit(): {driver}")
    out = {"fit_s": fit_s}
    for kind, _, lr in ZERO_RUNS:
        base = bases.pop(kind)
        ranks = []
        for r in range(2):
            with open(os.path.join(d, f"{kind}_rank{r}.json")) as f:
                ranks.append(json.load(f))
        flat = torch.load(os.path.join(d, f"{kind}_params.pt"))
        r0, r1 = ranks
        loss, base_loss = r0["losses"][-1], base["losses"][-1]
        if r0["params_sha"] != r1["params_sha"]:
            fail(f"17c {kind}: the two ranks' params differ")
        if kind == "fp32":
            if not torch.allclose(flat, base["flat"], rtol=1e-4, atol=1e-6):
                err = (flat - base["flat"]).abs().max().item()
                fail(f"17c fp32: params {err:.3g} from the baseline's, "
                     f"beyond rtol 1e-4 / atol 1e-6")
            tol = 1e-4
        else:
            tol = 0.1  # tests/test_zero.py: loss parity under int8 moments
        if abs(loss - base_loss) > tol * abs(base_loss):
            fail(f"17c {kind}: loss {loss} vs the baseline's {base_loss}, "
                 f"beyond rtol {tol}")
        for r in ranks:
            gauge = [v for _tags, v in r["gauge"]]
            if not gauge or gauge[0] != r["state_bytes"] or \
                    gauge[0] >= 0.62 * base["state_bytes"]:
                fail(f"17c {kind}: rank {r['rank']}'s opt-state gauge "
                     f"{gauge} (state {r['state_bytes']}) not under 0.62 x "
                     f"the baseline's {base['state_bytes']}")
        want = train_launches(gpt2_train_config(), ZERO_STEPS)
        for r in ranks:
            if r["launches"] != want:
                fail(f"17c {kind}: rank {r['rank']} launched "
                     f"{r['launches']}, expected {want}")
        moved = sum(v for tags, v in r0["coll_bytes"]
                    if dict(map(tuple, tags)).get("compression",
                                                  "none") ==
                    (("int8_block" if kind == "int8" else "none")))
        out[kind] = {"lr": lr, "losses": r0["losses"],
                     "base_losses": base["losses"],
                     "state_bytes": r0["state_bytes"],
                     "base_state_bytes": base["state_bytes"],
                     "ring_ms": r0["ring_ms"], "rank1_ring_ms": r1["ring_ms"],
                     "coll_bytes_rank0": r0["coll_bytes"],
                     "max_abs_vs_base": (flat - base["flat"]).abs().max()
                     .item(), "launches": r0["launches"]}
        print(f"17c zero-1 {kind} at lr {lr} (2 ranks sharing one H100, "
              f"{card}): ring step ms "
              f"{[round(x, 3) for x in r0['ring_ms']]}; rank 0 put "
              f"{moved / 1e9:.3f} GB on the wire as "
              f"{'int8' if kind == 'int8' else 'f32'} in {ZERO_STEPS} steps; "
              f"opt state {r0['state_bytes'] / 1e9:.3f} GB vs "
              f"{base['state_bytes'] / 1e9:.3f} unsharded; losses "
              f"{r0['losses']} vs {base['losses']}", flush=True)
        del base, flat
        gc.collect()
    print(f"17c fit() {fit_s:.3f} s for both runs", flush=True)
    return out


def train_tune_17d(torch, rt, kernels, card: str, root: str, first_loss,
                   prepare=None) -> dict:
    """17d: Tune over the trainer, a grid of two rates, each trial one
    nested TorchTrainer worker with half the card."""
    from ray_tpu_torch import train as tr
    from ray_tpu_torch import tune

    zero(kernels)
    t0 = time.time()
    grid = tune.Tuner(
        tr.TorchTrainer(
            tune_loop, train_loop_config={"prepare": prepare},
            scaling_config=tr.ScalingConfig(
                num_workers=1, resources_per_worker={"GPU": 0.5})),
        # a flat space: the searchers resolve top-level keys, and the nested
        # trainer takes a flat trial config as its train_loop_config
        param_space={"lr": tune.grid_search(list(TUNE_LRS))},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=2),
        run_config=tr.RunConfig(name="tune17",
                                storage_path=os.path.join(root, "17d"))
    ).fit()
    fit_s = time.time() - t0
    driver = counts(kernels)
    if any(driver.values()):
        fail(f"17d: the driver launched kernels during fit(): {driver}")
    results = [grid[i] for i in range(len(grid))]
    if len(results) != 2 or any(r.error for r in results):
        fail(f"17d: results {[(r.config, r.error) for r in results]}")
    want = train_launches(gpt2_train_config(), TUNE_STEPS)
    for r in results:
        m = r.metrics
        if m["losses"][0] != first_loss:
            fail(f"17d: trial {r.config} first loss {m['losses'][0]} is "
                 f"not 17b's first-step loss {first_loss}")
        if m["launches"] != want:
            fail(f"17d: trial {r.config} launched {m['launches']}, "
                 f"expected {want}")
    best = grid.get_best_result()
    lowest = min(results, key=lambda r: r.metrics["loss"])
    if best.metrics["loss"] != lowest.metrics["loss"]:
        fail(f"17d: best result {best.config} is not the lowest last loss")
    out = {"fit_s": fit_s, "trials": [
        {"lr": r.metrics["lr"], "losses": r.metrics["losses"],
         "launches": r.metrics["launches"]} for r in results],
        "best_lr": best.metrics["lr"]}
    print(f"17d tune over TorchTrainer on {card}: 2 trials sharing the card "
          f"in {fit_s:.3f} s; last losses "
          f"{[(t['lr'], t['losses'][-1]) for t in out['trials']]}; best lr "
          f"{out['best_lr']}", flush=True)
    return out


def train_phase(torch, rt, kernels, card: str, prepare=None) -> dict:
    """Phase 17 in a fresh session with TRAIN_ENV: 17a-d; after shutdown()
    no segment of the session is left, and the storage holds only
    committed checkpoints."""
    import glob
    import shutil
    import tempfile

    from ray_tpu_torch._private.ray_config import RayConfig

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in TRAIN_ENV}
    os.environ.update(TRAIN_ENV)
    RayConfig.reset()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    out = {}
    try:
        # pre-started CPU workers take the controllers, sync actors and
        # trial runners, which import no torch
        info = rt.init(num_cpus=8, num_workers=4, max_workers=16)
        sid = out["session"] = info["session_id"]
        for name, fn in (("17a", train_fit_17a), ("17b", train_resume_17b),
                         ("17c", train_zero_17c)):
            t0 = time.perf_counter()
            out[name] = fn(torch, rt, kernels, card, root, prepare)
            out[name]["sub_phase_s"] = time.perf_counter() - t0
            print(f"{name} took {out[name]['sub_phase_s']:.1f} s", flush=True)
        t0 = time.perf_counter()
        out["17d"] = train_tune_17d(torch, rt, kernels, card, root,
                                    out["17b"]["ref_losses"][0], prepare)
        out["17d"]["sub_phase_s"] = time.perf_counter() - t0
        print(f"17d took {out['17d']['sub_phase_s']:.1f} s", flush=True)
    finally:
        rt.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        RayConfig.reset()
        shutil.rmtree(root, ignore_errors=True)
    left = glob.glob(f"/dev/shm/rtpt_{sid}*")
    if left:
        fail(f"17: shm segments of the session left: {sorted(left)}")
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = out["17a"]["launches"]
    print(f"train and tune on {card}: phase 17 took {out['phase_s']:.1f} s",
          flush=True)
    return out


# ----------------------------------------------------------------- phase 18

DAG_ENV = {
    # 18a's and 18c's actors hold a GPU share under 1, which binds no card:
    # they reach it as the PD pools do
    "RAY_TPU_TORCH_WORKER_PLATFORM": "cuda",
    # 18a's export stages 128 MiB of KV (and the logits) through the store
    "RAY_TPU_TORCH_STORE_CAPACITY": str(4 << 30)}
DEV_PROMPT = 1024                # 18a's prompt, one bucket
DEV_MARKERS_MAX = 64 << 10       # the result object in the driver's store
DEV_MEM_SLACK = 1 << 20          # the producer's memory after the free
DEV_FREE_S = 15.0
DAG_BUFFER = 64 << 10            # 18b's channels: a prompt's or 16 ids
CHAIN_STAGES = 4                 # 18c
CHAIN_STEPS = 25                 # cut from 200 to 50 for phase 23, 25 for 20c
CHAIN_SIZES = (16 << 10, 16 << 20)   # 18c's bf16 payloads, in bytes


def device_prompt(vocab: int) -> list[int]:
    """18a's 1024-token prompt, from a numpy seed."""
    import numpy as np

    return np.random.default_rng(SEED + 18).integers(
        0, vocab, size=DEV_PROMPT).tolist()


def phase4_prompts(vocab: int) -> list[list[int]]:
    """Phase 4's 8 prompts (serve()'s token rows of SERVE_LENGTHS)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(0, vocab, size=n).tolist() for n in SERVE_LENGTHS]


def dag_expected(torch, cfg, params) -> dict:
    """What phase 18 must reproduce, in process on phase 10's weights: the
    greedy token of 18a's prompt from ``decoding.prefill`` (and its KV's
    byte hashes, reported), and 18b's ids: an LLMEngine built as the DAG's
    engine actor builds its own (phase 4's engine options), greedy with 32
    tokens and no stop token, serving each of phase 4's prompts alone."""
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models import decoding

    ids = torch.tensor([device_prompt(cfg.vocab_size)], device="cuda")
    with torch.no_grad():
        logits, kv = decoding.prefill(params, ids, DEV_PROMPT, cfg)
    torch.cuda.synchronize()
    out = {"token": int(torch.argmax(logits)),
           "hashes": {n: tensor_sha(torch, t) for n, t in
                      (("k", kv["k"]), ("v", kv["v"]), ("logits", logits))}}
    del logits, kv
    built = LLMConfig(engine_kwargs=http_engine_kwargs())
    built.build_model = lambda device=None: (cfg, params)
    eng = LLMEngine.from_config(built)
    try:
        sp = SamplingParams(max_tokens=HTTP_MAX_TOKENS, temperature=0.0)
        out["ids"] = [eng.generate(p, sp)
                      for p in phase4_prompts(cfg.vocab_size)]
    finally:
        eng.shutdown()
    return out


def tensor_sha(torch, t) -> str:
    """sha256 of a tensor's raw bytes (read back to the host)."""
    import hashlib

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()


def device_producer(rt, prepare=None):
    """18a's producer class: Llama-3-8B on its card (phase 10's weights,
    from the seed), whose prefill returns the prompt's KV and logits as
    device objects. Export times are read by wrapping the module's
    export_to_store in this process (the worker calls it through the
    module). Pickled by value into the actor."""

    class Producer:
        def __init__(self):
            if prepare is not None:
                prepare()
            import time

            import torch

            from ray_tpu_torch.experimental import device_objects
            from ray_tpu_torch.models import llama, transformer

            self.cfg = llama.llama_config("8b")
            self.params = transformer.init(
                torch.Generator(device="cuda").manual_seed(SEED), self.cfg,
                torch.device("cuda"), dtype=self.cfg.dtype)
            torch.cuda.synchronize()
            self.exports: list = []
            self.made: dict = {}
            export = device_objects.export_to_store

            def timed(tensor_id, worker):
                with device_objects._lock:
                    t = device_objects._registry.get(tensor_id)
                nbytes = 0 if t is None else t.numel() * t.element_size()
                t0 = time.perf_counter()
                oid = export(tensor_id, worker)
                self.exports.append({"bytes": nbytes,
                                     "s": time.perf_counter() - t0})
                return oid

            device_objects.export_to_store = timed

        def fingerprints(self) -> dict:
            import torch

            return weight_fingerprints(torch, self.params)

        def warm(self) -> None:
            """A short prefill whose outputs are dropped: the process's
            first matmuls allocate cuBLAS's workspace (32 MiB, counted in
            memory_allocated() for good), which must not count against
            the measured call."""
            import torch

            from ray_tpu_torch.models import decoding

            tokens = torch.zeros((1, 64), dtype=torch.int64, device="cuda")
            with torch.no_grad():
                decoding.prefill(self.params, tokens, 64, self.cfg)
            torch.cuda.synchronize()

        def memory(self) -> tuple:
            import gc

            import torch

            from ray_tpu_torch.experimental import device_objects

            gc.collect()
            torch.cuda.synchronize()
            return (device_objects.registry_size(),
                    torch.cuda.memory_allocated())

        def probe(self, zero_counts: bool = False) -> dict:
            kernels = loop_kernels()
            out = counts(kernels)
            if zero_counts:
                zero(kernels)
            return {"launches": out, "exports": list(self.exports),
                    "n_layers": self.cfg.n_layers}

        @rt.method(tensor_transport="device")
        def prefill(self, ids):
            import torch

            from ray_tpu_torch.models import decoding

            tokens = torch.tensor([ids], device="cuda")
            with torch.no_grad():
                logits, kv = decoding.prefill(self.params, tokens, len(ids),
                                              self.cfg)
            torch.cuda.synchronize()
            out = {"k": kv["k"], "v": kv["v"], "logits": logits}
            self.made = {n: (t.data_ptr(), tensor_sha(torch, t))
                         for n, t in out.items()}
            return out

        def self_call(self, payload) -> dict:
            """The payload resolved in this process: the registry's own
            tensors (same storage), and the greedy token."""
            import torch

            return {"same_ptr": all(payload[n].data_ptr() == ptr
                                    for n, (ptr, _h) in self.made.items()),
                    "token": int(torch.argmax(payload["logits"])),
                    "hashes": {n: h for n, (_p, h) in self.made.items()}}

    return Producer


def device_consumer(prepare=None):
    """18a's consumer class: resolves the producer's ref in its own process
    and reports what it got; pickled by value into the actor."""

    class Consumer:
        def __init__(self):
            if prepare is not None:
                prepare()
            import torch

            torch.empty(1, device=torch.device("cuda"))
            zero(loop_kernels())

        def take(self, refs) -> dict:
            import time

            import ray_tpu_torch
            import torch

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = ray_tpu_torch.get(refs[0], timeout=300)
            torch.cuda.synchronize()
            get_s = time.perf_counter() - t0
            out = {"get_ms": 1e3 * get_s,
                   "tensors": {n: {"device": t.device.type,
                                   "dtype": str(t.dtype),
                                   "shape": list(t.shape),
                                   "sha": tensor_sha(torch, t)}
                               for n, t in payload.items()},
                   "launches": counts(loop_kernels())}
            del payload
            return out

    return Consumer


def dag_engine_actor(prepare=None):
    """18b's engine actor class: an LLMEngine on the paged layout, built as
    phase 14's replica builds its engine (Llama-3-8B, phase 10's weights
    from the seed); `generate` serves one prompt greedily, 16 tokens."""

    class Engine:
        def __init__(self):
            if prepare is not None:
                prepare()
            from ray_tpu_torch.llm import (LLMConfig, LLMEngine,
                                           ModelLoadingConfig, SamplingParams)

            self.engine = LLMEngine.from_config(LLMConfig(
                model_loading_config=ModelLoadingConfig(model_id="8b"),
                engine_kwargs=http_engine_kwargs()))
            self.sp = SamplingParams(max_tokens=HTTP_MAX_TOKENS,
                                     temperature=0.0)

        def generate(self, ids):
            return self.engine.generate(list(ids), self.sp)

        def probe(self, zero_counts: bool = False) -> dict:
            kernels = loop_kernels()
            st = self.engine.stats()
            out = {"launches": counts(kernels), "prefills": st["prefills"],
                   "decode_steps": st["decode_steps"],
                   "n_layers": self.engine.cfg.n_layers}
            if zero_counts:
                zero(kernels)
            return out

        def fingerprints(self) -> dict:
            import torch

            return weight_fingerprints(torch, self.engine.params)

    return Engine


class DagPost:
    """18b's CPU stage: the engine's token ids as plain ints."""

    def ids(self, out):
        return [int(t) for t in out]


class ChainStage:
    """18c's stage: x + 1 on the tensor it is handed (on its card)."""

    def __init__(self, prepare=None):
        if prepare is not None:
            prepare()
        import torch

        torch.empty(1, device=torch.device("cuda"))

    def work(self, x):
        return x + 1


def median_us(samples) -> float:
    import statistics

    return 1e6 * statistics.median(samples)


def device_objects_18a(torch, rt, card: str, expected: dict, fps10: dict,
                       prepare=None) -> dict:
    """18a: the producer's prefill result crosses as markers; a self-call
    sees its own storage, a consumer in another process gets byte-equal
    CUDA tensors, and dropping the refs frees the producer's memory."""
    from ray_tpu_torch.util import state

    Producer = rt.remote(num_gpus=0.5)(device_producer(rt, prepare))
    Consumer = rt.remote(num_gpus=0.5)(device_consumer(prepare))
    p, c = Producer.remote(), Consumer.remote()
    kernels = loop_kernels()
    out = {}
    try:
        fps = rt.get(p.fingerprints.remote(), timeout=600)
        if fps != fps10:
            fail(f"18a: the producer's weights differ from phase 10's: "
                 f"{fps} vs {fps10}")
        ids = device_prompt(llama_vocab())
        rt.get(p.warm.remote(), timeout=300)
        reg0, mem0 = rt.get(p.memory.remote(), timeout=60)
        rt.get(p.probe.remote(True), timeout=60)
        zero(kernels)  # the main path starts here
        t0 = time.perf_counter()
        ref = p.prefill.remote(ids)
        rt.wait([ref], num_returns=1, timeout=300)
        out["prefill_call_ms"] = 1e3 * (time.perf_counter() - t0)
        rows = state.list_objects(filters=[("object_id", "=", ref.hex())])
        out["result_object_bytes"] = rows[0]["size"] if rows else None
        mine = rt.get(p.self_call.remote(ref), timeout=120)
        got = rt.get(c.take.remote([ref]), timeout=600)
        prod = rt.get(p.probe.remote(), timeout=60)
        out["launches"] = prod["launches"]
        out["consumer_launches"] = got["launches"]
        out["driver_launches"] = counts(kernels)
        del ref
        gc.collect()
        t_free = time.perf_counter()
        reg, mem = reg0 + 1, None
        while time.perf_counter() - t_free < DEV_FREE_S:
            reg, mem = rt.get(p.memory.remote(), timeout=60)
            if reg == reg0 and abs(mem - mem0) <= DEV_MEM_SLACK:
                break
            time.sleep(0.2)
        out["free_s"] = time.perf_counter() - t_free
    finally:
        for a in (p, c):
            rt.kill(a)
    n_layers = prod["n_layers"]
    if out["result_object_bytes"] is None \
            or out["result_object_bytes"] >= DEV_MARKERS_MAX:
        fail(f"18a: the result object holds {out['result_object_bytes']} "
             f"bytes in the driver's store (markers only: < "
             f"{DEV_MARKERS_MAX})")
    if not mine["same_ptr"]:
        fail("18a: the self-call's tensors are not the producer's own")
    if mine["token"] != expected["token"]:
        fail(f"18a: greedy token {mine['token']} != in-process prefill's "
             f"{expected['token']}")
    for n, t in got["tensors"].items():
        if t["device"] != "cuda":
            fail(f"18a: the consumer's {n} is on {t['device']}")
        if t["sha"] != mine["hashes"][n]:
            fail(f"18a: the consumer's {n} differs from the producer's bytes")
    if sorted(got["tensors"]) != ["k", "logits", "v"]:
        fail(f"18a: the consumer got {sorted(got['tensors'])}")
    want = {"flash_attention_fwd_bf16": n_layers}
    for sym, n in out["launches"].items():
        if n != want.get(sym, 0):
            fail(f"18a: {sym} launched {n} times in the producer, expected "
                 f"{want.get(sym, 0)}")
    for where in ("consumer_launches", "driver_launches"):
        if any(out[where].values()):
            fail(f"18a: launches in the {where.split('_')[0]}: {out[where]}")
    if reg != reg0 or abs(mem - mem0) > DEV_MEM_SLACK:
        fail(f"18a: {DEV_FREE_S} s after the last ref went the producer "
             f"holds {reg} registry entries (before: {reg0}) and "
             f"{mem - mem0} bytes more than before the call")
    ex = prod["exports"]
    ex_bytes, ex_s = sum(e["bytes"] for e in ex), sum(e["s"] for e in ex)
    out.update({
        "self_call": {"same_ptr": True, "token": mine["token"]},
        "kv_equal_in_process": all(
            mine["hashes"][n] == expected["hashes"][n] for n in ("k", "v")),
        "consumer": {n: {k: v for k, v in t.items() if k != "sha"}
                     for n, t in got["tensors"].items()},
        "consumer_get_ms": got["get_ms"], "exports": ex,
        "export_ms": 1e3 * ex_s, "export_bytes": ex_bytes,
        "export_GBps": ex_bytes / ex_s / 1e9 if ex_s else None,
        "memory_before": mem0, "memory_after": mem})
    print(f"18a device objects on {card}: result object "
          f"{out['result_object_bytes']} B in the driver's store; export of "
          f"{len(ex)} tensors, {ex_bytes / 2**20:.1f} MiB in "
          f"{out['export_ms']:.3f} ms ({out['export_GBps']:.3f} GB/s); the "
          f"consumer's get {got['get_ms']:.3f} ms; freed in "
          f"{out['free_s']:.3f} s", flush=True)
    return out


def llama_vocab() -> int:
    from ray_tpu_torch.models import llama

    return llama.llama_config("8b").vocab_size


def compiled_llm_18b(torch, rt, card: str, expected: dict, fps10: dict,
                     prepare=None) -> dict:
    """18b: InputNode → Engine.generate → Post.ids compiled onto the
    channel plane; phase 4's prompts one after the other, then 8 in
    flight, token-exact to in-process serving of each prompt alone."""
    import glob

    from ray_tpu_torch._private.constants import SHM_CHANNEL_GLOB
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.util import state

    Engine = rt.remote(num_gpus=1)(dag_engine_actor(prepare))
    Post = rt.remote(DagPost)
    eng, post = Engine.remote(), Post.remote()
    kernels = loop_kernels()
    prompts = phase4_prompts(llama_vocab())
    chans0 = set(glob.glob(SHM_CHANNEL_GLOB))
    out = {}
    try:
        t0 = time.perf_counter()
        fps = rt.get(eng.fingerprints.remote(), timeout=900)
        out["engine_ready_s"] = time.perf_counter() - t0
        if fps != fps10:
            fail(f"18b: the engine actor's weights differ from phase 10's: "
                 f"{fps} vs {fps10}")
        before = rt.get(eng.probe.remote(True), timeout=60)
        zero(kernels)  # the main path starts here
        with InputNode() as inp:
            dag = post.ids.bind(eng.generate.bind(inp))
        t0 = time.perf_counter()
        compiled = dag.experimental_compile(
            channel_buffer_bytes=DAG_BUFFER,
            max_inflight_executions=len(prompts))
        out["compile_s"] = time.perf_counter() - t0
        out["uses_channels"] = compiled.uses_channels
        out["fallback_reason"] = compiled.fallback_reason
        if not compiled.uses_channels or compiled.fallback_reason is not None:
            compiled.teardown()
            fail(f"18b: the DAG took the submit path "
                 f"({compiled.fallback_reason})")
        rows = state.list_compiled_dags(
            filters=[("dag_id", "=", compiled.dag_id)])
        out["registry"] = rows[0] if rows else None
        t0 = time.perf_counter()
        seq = [compiled.execute(p).result(timeout=600) for p in prompts]
        out["sequential_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        futs = [compiled.execute(p) for p in prompts]
        inflight = [f.result(timeout=600) for f in futs]
        out["in_flight_s"] = time.perf_counter() - t0
        compiled.teardown()
        out["registry_after"] = state.list_compiled_dags(
            filters=[("dag_id", "=", compiled.dag_id)])
        out["driver_launches"] = counts(kernels)
        after = rt.get(eng.probe.remote(), timeout=60)
        # the actor serves normal calls after teardown
    finally:
        for a in (eng, post):
            rt.kill(a)
    left = set(glob.glob(SHM_CHANNEL_GLOB)) - chans0
    if left:
        fail(f"18b: teardown left channel segments {sorted(left)}")
    reg = out["registry"]
    if not reg or reg.get("plane") != "channels":
        fail(f"18b: list_compiled_dags() shows {reg}")
    if out["registry_after"]:
        fail("18b: the DAG is still registered after teardown")
    for name, got in (("one after the other", seq), ("8 in flight", inflight)):
        for i, (g, want) in enumerate(zip(got, expected["ids"])):
            if g != want:
                fail(f"18b ({name}): prompt {i} of {SERVE_LENGTHS[i]} "
                     f"tokens gave {g[:8]}..., in process {want[:8]}...")
    prefills = after["prefills"] - before["prefills"]
    steps = after["decode_steps"] - before["decode_steps"]
    L = after["n_layers"]
    want = {"flash_attention_fwd_bf16": L * prefills,
            "ragged_paged_attention_bf16": L * steps}
    if not prefills or not steps:
        fail(f"18b: the engine ran {prefills} prefills, {steps} steps")
    for sym, n in after["launches"].items():
        if n != want.get(sym, 0):
            fail(f"18b: {sym} launched {n} times in the engine actor, "
                 f"expected {want.get(sym, 0)}")
    if any(out["driver_launches"].values()):
        fail(f"18b: launches in the driver: {out['driver_launches']}")
    out.update({"launches": after["launches"], "prefills": prefills,
                "decode_steps": steps, "requests": 2 * len(prompts),
                "tokens_per_s_in_flight":
                    sum(len(g) for g in inflight) / out["in_flight_s"]})
    out["registry"] = {k: reg[k] for k in ("dag_id", "plane", "channels",
                                           "actors")}
    print(f"18b compiled DAG on {card}: {len(prompts)} prompts one after the "
          f"other in {out['sequential_s']:.3f} s, 8 in flight in "
          f"{out['in_flight_s']:.3f} s "
          f"({out['tokens_per_s_in_flight']:.1f} tokens/s), token-exact; "
          f"{reg['channels']} channels; compile {out['compile_s']:.3f} s",
          flush=True)
    return out


def chain_gate(path: str, nbytes: int, bad: list) -> None:
    """18c's gate: every step came back a CUDA tensor equal to x + 4."""
    off, wrong = bad
    if off or wrong:
        fail(f"18c: of {CHAIN_STEPS} {path} steps of {nbytes} B, {off} came "
             f"back off the card and {wrong} differ from x + {CHAIN_STAGES}")


def channel_chain_18c(torch, rt, card: str, prepare=None) -> dict:
    """18c: x + 1 through 4 actors sharing the card, on bf16 CUDA tensors
    of 16 KiB and 16 MiB: compiled onto channels, then through .remote();
    exact, with median step times."""
    Stage = rt.remote(num_gpus=1 / CHAIN_STAGES)(ChainStage)
    actors = [Stage.remote(prepare) for _ in range(CHAIN_STAGES)]
    from ray_tpu_torch.dag import InputNode

    out = {"sizes": {}}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    try:
        with InputNode() as inp:
            node = inp
            for a in actors:
                node = a.work.bind(node)
        compiled = node.experimental_compile(
            channel_buffer_bytes=max(CHAIN_SIZES) + (64 << 10))
        if not compiled.uses_channels or compiled.fallback_reason is not None:
            compiled.teardown()
            fail(f"18c: the chain took the submit path "
                 f"({compiled.fallback_reason})")
        xs = {}
        for nbytes in CHAIN_SIZES:
            # small integers: x + 4 is exact in bf16
            x = torch.randint(0, 100, (nbytes // 2,), generator=gen,
                              device="cuda").to(torch.bfloat16)
            want = x + CHAIN_STAGES
            xs[nbytes] = (x, want)
            for _ in range(10):
                compiled.execute(x).result(timeout=120)
            steps, bad = [], [0, 0]
            for _ in range(CHAIN_STEPS):
                t0 = time.perf_counter()
                y = compiled.execute(x).result(timeout=120)
                steps.append(time.perf_counter() - t0)
                bad[0] += not y.is_cuda
                bad[1] += not torch.equal(y.to(want.device), want)
            chain_gate("compiled", nbytes, bad)
            out["sizes"][nbytes] = {"compiled_us": median_us(steps)}
        compiled.teardown()
        for nbytes, (x, want) in xs.items():
            def chain():
                ref = x
                for a in actors:
                    ref = a.work.remote(ref)
                return rt.get(ref, timeout=120)

            for _ in range(3):
                chain()
            steps, bad = [], [0, 0]
            for _ in range(CHAIN_STEPS):
                t0 = time.perf_counter()
                y = chain()
                steps.append(time.perf_counter() - t0)
                bad[0] += not y.is_cuda
                bad[1] += not torch.equal(y.to(want.device), want)
            chain_gate(".remote()", nbytes, bad)
            row = out["sizes"][nbytes]
            row["remote_us"] = median_us(steps)
            row["payload_GBps"] = nbytes / (row["compiled_us"] * 1e-6) / 1e9
            row["speedup"] = row["remote_us"] / row["compiled_us"]
    finally:
        for a in actors:
            rt.kill(a)
    for nbytes, row in out["sizes"].items():
        print(f"18c chain of {CHAIN_STAGES} on {card}, {nbytes} B bf16: "
              f"compiled step median {row['compiled_us']:.1f} us, .remote() "
              f"{row['remote_us']:.1f} us ({row['speedup']:.2f}x), "
              f"{row['payload_GBps']:.3f} GB/s of payload", flush=True)
    return out


def dag_phase(torch, rt, card: str, expected: dict, fps10: dict,
              prepare=None) -> dict:
    """Phase 18 in a fresh session with DAG_ENV: 18a, 18b, 18c; after
    shutdown() no segment of the session is left."""
    import glob

    from ray_tpu_torch._private.ray_config import RayConfig

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in DAG_ENV}
    os.environ.update(DAG_ENV)
    RayConfig.reset()
    out = {}
    try:
        info = rt.init(num_cpus=8)
        sid = out["session"] = info["session_id"]
        for name, fn, args in (
                ("18a", device_objects_18a, (expected, fps10)),
                ("18b", compiled_llm_18b, (expected, fps10)),
                ("18c", channel_chain_18c, ())):
            t0 = time.perf_counter()
            out[name] = fn(torch, rt, card, *args, prepare=prepare)
            out[name]["sub_phase_s"] = time.perf_counter() - t0
            print(f"{name} took {out[name]['sub_phase_s']:.1f} s", flush=True)
    finally:
        rt.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        RayConfig.reset()
    left = glob.glob(f"/dev/shm/rtpt_{sid}*")
    if left:
        fail(f"18: shm segments of the session left: {sorted(left)}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"device objects and compiled DAGs on {card}: phase 18 took "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------- phase 19

HOST_ENV = {
    # the head's and the followers' workers: whole-GPU grants reach the
    # card through CUDA_VISIBLE_DEVICES; CPU workers are not hidden from it
    "RAY_TPU_TORCH_WORKER_PLATFORM": "cuda",
    # 19a's 128 MiB of KV and 19b's 256 MiB tensors land in each host's
    # store (the agents inherit the driver's env)
    "RAY_TPU_TORCH_STORE_CAPACITY": str(4 << 30)}
# host-1 keeps its objects in the file store and serves them through the
# C++ object server; host-2 keeps the default arena and the Python server
NATIVE_ENV = {"RAY_TPU_TORCH_STORE_BACKEND": "file",
              "RAY_TPU_TORCH_OBJECT_SERVER_BACKEND": "native"}
PULL_BYTES = 256 << 20           # 19b's bf16 tensor
PULL_ROUNDS = 1                  # 19b: native, python (cut from 2 for 20c)
HOST_MEM_SLACK = 1 << 30         # 19c: the card's free memory after shutdown
LOST_ELEMS = 1 << 20             # 19c: an f32 object only host-1 holds
HOST_WAIT_S = 900.0


def host_id() -> str:
    return os.environ.get("RAY_TPU_TORCH_HOST_ID", "host-0")


def follower_serve(prepare=None, n_prompts: int | None = None):
    """19a's task body (pickled by value into a num_gpus=1 worker on
    host-1): Llama-3-8B from the seed (phase 10's weights), 18a's prefill,
    then an LLMEngine with phase 14's options serving phase 4's prompts (or
    the last `n_prompts` of them) greedily, each alone (as ``dag_expected``
    does in process). Returns the
    KV and the logits as CUDA tensors, with the ids, the weights'
    fingerprints, the engine's counters and this worker's launch counts."""

    def run():
        if prepare is not None:
            prepare()
        import torch

        from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
        from ray_tpu_torch.models import decoding, llama, transformer

        kernels = loop_kernels()
        zero(kernels)
        cfg = llama.llama_config("8b")
        params = transformer.init(
            torch.Generator(device="cuda").manual_seed(SEED), cfg,
            torch.device("cuda"), dtype=cfg.dtype)
        fps = weight_fingerprints(torch, params)
        tokens = torch.tensor([device_prompt(cfg.vocab_size)], device="cuda")
        with torch.no_grad():
            logits, kv = decoding.prefill(params, tokens, DEV_PROMPT, cfg)
        torch.cuda.synchronize()
        built = LLMConfig(engine_kwargs=http_engine_kwargs())
        built.build_model = lambda device=None: (cfg, params)
        eng = LLMEngine.from_config(built)
        try:
            sp = SamplingParams(max_tokens=HTTP_MAX_TOKENS, temperature=0.0)
            prompts = phase4_prompts(cfg.vocab_size)
            ids = [eng.generate(p, sp)
                   for p in prompts[-(n_prompts or len(prompts)):]]
            st = eng.stats()
        finally:
            eng.shutdown()
        torch.cuda.synchronize()
        out = {"k": kv["k"], "v": kv["v"], "logits": logits, "ids": ids,
               "hashes": {n: tensor_sha(torch, t) for n, t in
                          (("k", kv["k"]), ("v", kv["v"]),
                           ("logits", logits))},
               "fingerprints": fps, "launches": counts(kernels),
               "prefills": st["prefills"],
               "decode_steps": st["decode_steps"],
               "n_layers": cfg.n_layers, "host": host_id()}
        del built, eng, params
        gc.collect()
        torch.cuda.empty_cache()
        return out

    return run


def tensor_on_host(nbytes: int, seed: int, prepare=None):
    """19b's task body: a seeded bf16 CUDA tensor of `nbytes` put into this
    host's store; returns its ref and the sha256 of its bytes."""

    def run():
        if prepare is not None:
            prepare()
        import torch

        import ray_tpu_torch

        g = torch.Generator(device="cuda").manual_seed(seed)
        t = torch.randn(nbytes // 2, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        torch.cuda.synchronize()
        return {"ref": ray_tpu_torch.put(t), "sha": tensor_sha(torch, t),
                "host": host_id()}

    return run


def lost_object():
    """19c: an object only this host's store holds (never pulled)."""

    def run():
        import numpy as np

        import ray_tpu_torch

        return ray_tpu_torch.put(np.ones(LOST_ELEMS, dtype=np.float32))

    return run


def retried_prefill(flag: str, prepare=None):
    """19c's task body: Llama-3-8B from the seed and 18a's prefill. On a
    follower host the attempt marks `flag` after its first prefill and
    keeps prefilling until its host is lost; the retry on the head returns
    the greedy token with its own launch counts."""

    def run():
        if prepare is not None:
            prepare()
        import time

        import torch

        from ray_tpu_torch.models import decoding, llama, transformer

        kernels = loop_kernels()
        zero(kernels)
        cfg = llama.llama_config("8b")
        params = transformer.init(
            torch.Generator(device="cuda").manual_seed(SEED), cfg,
            torch.device("cuda"), dtype=cfg.dtype)
        tokens = torch.tensor([device_prompt(cfg.vocab_size)], device="cuda")
        with torch.no_grad():
            logits, _kv = decoding.prefill(params, tokens, DEV_PROMPT, cfg)
            torch.cuda.synchronize()
            if host_id() != "host-0":
                open(flag, "w").close()
                deadline = time.monotonic() + HOST_WAIT_S
                while time.monotonic() < deadline:
                    logits, _kv = decoding.prefill(params, tokens,
                                                   DEV_PROMPT, cfg)
                    torch.cuda.synchronize()
        return {"host": host_id(), "token": int(torch.argmax(logits)),
                "launches": counts(kernels), "n_layers": cfg.n_layers}

    return run


class PullTimer:
    """Times the driver's cross-host pulls: wraps its CoreWorker's
    ``_pull_remote`` (the get path calls it through the instance) and its
    store's ``put_parts`` (where the fetcher lands the bytes), and records
    each pull's bytes, seconds, the part spent writing the store, and the
    addresses it was offered."""

    def __init__(self, worker):
        self.worker, self.pulls, self.writes = worker, [], {}
        orig, put = worker._pull_remote, worker.store.put_parts

        def timed(oid, reply):
            t0 = time.perf_counter()
            ok = orig(oid, reply)
            self.pulls.append({
                "oid": oid, "ok": ok, "bytes": reply.get("size", 0),
                "s": time.perf_counter() - t0,
                "from": [list(loc) for loc in reply.get("locations") or ()]})
            return ok

        def timed_put(oid, parts, total):
            t0 = time.perf_counter()
            tier = put(oid, parts, total)
            self.writes[oid] = time.perf_counter() - t0
            return tier

        worker._pull_remote = timed
        worker.store.put_parts = timed_put

    def close(self) -> None:
        self.worker.__dict__.pop("_pull_remote", None)
        self.worker.store.__dict__.pop("put_parts", None)

    def of(self, oid: str) -> dict:
        mine = [p for p in self.pulls if p["oid"] == oid]
        if len(mine) != 1 or not mine[0]["ok"]:
            fail(f"19: expected one successful pull of {oid}, got {mine}")
        p = dict(mine[0])
        p["ms"] = 1e3 * p["s"]
        p["GBps"] = p["bytes"] / p["s"] / 1e9
        # the rest of the pull is the transfer: connect, request, receive
        p["store_write_ms"] = 1e3 * self.writes.get(oid, float("nan"))
        p["transfer_ms"] = p["ms"] - p["store_write_ms"]
        return p


def object_hosts(rt, oid: str) -> list:
    gcs = rt._private.api._node.gcs
    with gcs.lock:
        return sorted(gcs.objects.get(oid, {}).get("hosts", ()))


def wait_hosts(rt, oid: str, want: list, timeout_s: float = 10.0) -> list:
    deadline = time.monotonic() + timeout_s
    got = object_hosts(rt, oid)
    while got != want and time.monotonic() < deadline:
        time.sleep(0.05)
        got = object_hosts(rt, oid)
    return got


def serve_from_follower_19a(torch, rt, card: str, expected: dict,
                            fps10: dict, prepare=None) -> dict:
    """19a: Llama-3-8B prefilled and served in host-1's GPU worker; the
    driver's get pulls the result from host-1's store into host-0's, then
    onto its card."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    kernels = loop_kernels()
    task = rt.remote(num_gpus=1)(follower_serve(prepare))
    zero(kernels)  # the main path starts here
    t0 = time.perf_counter()
    ref = task.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id="host-1")).remote()
    ready, _ = rt.wait([ref], num_returns=1, timeout=HOST_WAIT_S)
    out = {"task_s": time.perf_counter() - t0}
    if not ready:
        fail("19a: the follower's task did not finish")
    out["hosts_before_get"] = object_hosts(rt, ref.hex())
    timer = PullTimer(rt._private.api._get_worker())
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = rt.get(ref, timeout=600)
        torch.cuda.synchronize()
        out["get_ms"] = 1e3 * (time.perf_counter() - t1)
    finally:
        timer.close()
    out["driver_launches"] = counts(kernels)
    out["hosts_after_get"] = wait_hosts(rt, ref.hex(), ["host-0", "host-1"])
    out["pull"] = timer.of(ref.hex())
    got = {n: {"device": res[n].device.type, "sha": tensor_sha(torch, res[n])}
           for n in ("k", "v", "logits")}
    token = int(torch.argmax(res["logits"]))
    out.update({"host": res["host"], "token": token, "ids": res["ids"],
                "launches": res["launches"], "prefills": res["prefills"],
                "decode_steps": res["decode_steps"],
                "n_layers": res["n_layers"],
                "tensors": {n: g["device"] for n, g in got.items()}})
    del res["k"], res["v"], res["logits"]
    if res["fingerprints"] != fps10:
        fail(f"19a: host-1's weights differ from phase 10's: "
             f"{res['fingerprints']} vs {fps10}")
    if res["host"] != "host-1":
        fail(f"19a: the task ran on {res['host']}, not host-1")
    if token != expected["token"]:
        fail(f"19a: greedy token {token} != in-process prefill's "
             f"{expected['token']}")
    for n, g in got.items():
        if g["device"] != "cuda":
            fail(f"19a: the driver's {n} is on {g['device']}")
        if g["sha"] != expected["hashes"][n] or \
                res["hashes"][n] != expected["hashes"][n]:
            fail(f"19a: {n} differs from in-process prefill's bytes "
                 f"(host-1 {res['hashes'][n] == expected['hashes'][n]}, "
                 f"the driver {g['sha'] == expected['hashes'][n]})")
    if res["ids"] != expected["ids"]:
        bad = [i for i, (a, b) in enumerate(zip(res["ids"], expected["ids"]))
               if a != b]
        fail(f"19a: the follower's engine ids differ from in-process "
             f"serving at prompts {bad}")
    L = res["n_layers"]
    want = {"flash_attention_fwd_bf16": L * (1 + res["prefills"]),
            "ragged_paged_attention_bf16": L * res["decode_steps"]}
    for sym, n in res["launches"].items():
        if n != want.get(sym, 0):
            fail(f"19a: {sym} launched {n} times in host-1's worker, "
                 f"expected {want.get(sym, 0)}")
    if any(out["driver_launches"].values()):
        fail(f"19a: launches in the driver: {out['driver_launches']}")
    if out["hosts_before_get"] != ["host-1"] or \
            out["hosts_after_get"] != ["host-0", "host-1"]:
        fail(f"19a: the result's locations were {out['hosts_before_get']} "
             f"before the get and {out['hosts_after_get']} after")
    p = out["pull"]
    print(f"19a llama-3-8b served from host-1 on {card}: task "
          f"{out['task_s']:.3f} s, token-exact, {len(res['ids'])} prompts "
          f"token-exact; pull of {p['bytes']} B from "
          f"{p['from'][0][1] if p['from'] else '?'} in {p['ms']:.3f} ms "
          f"({p['GBps']:.3f} GB/s: transfer {p['transfer_ms']:.3f}, store "
          f"write {p['store_write_ms']:.3f}), get {out['get_ms']:.3f} ms",
          flush=True)
    return out


def both_planes_19b(torch, rt, card: str, prepare=None) -> dict:
    """19b: a 256 MiB bf16 CUDA tensor put on host-1 (file store, C++
    server) and on host-2 (arena, Python server), each pulled by the
    driver, PULL_ROUNDS rounds; bytes sha256-equal on both ends."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    gcs = rt._private.api._node.gcs
    with gcs.lock:
        addrs = {h: info["object_addr"] for h, info in gcs.hosts.items()}
    if not str(addrs.get("host-1")).startswith("native:"):
        fail(f"19b: host-1's object address {addrs.get('host-1')!r} is not "
             f"the native server's")
    if str(addrs.get("host-2")).startswith("native:"):
        fail(f"19b: host-2's object address {addrs.get('host-2')!r} is the "
             f"native server's; its Python server was expected")
    out = {"addresses": addrs, "native": [], "python": []}
    for r in range(PULL_ROUNDS):
        for plane, host in (("native", "host-1"), ("python", "host-2")):
            task = rt.remote(num_gpus=1)(
                tensor_on_host(PULL_BYTES, SEED + 19 + r, prepare))
            made = rt.get(task.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=host)).remote(), timeout=HOST_WAIT_S)
            inner = made["ref"]
            before = object_hosts(rt, inner.hex())
            timer = PullTimer(rt._private.api._get_worker())
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t = rt.get(inner, timeout=600)
                torch.cuda.synchronize()
                get_ms = 1e3 * (time.perf_counter() - t0)
            finally:
                timer.close()
            pull = timer.of(inner.hex())
            row = {"bytes": pull["bytes"], "ms": pull["ms"],
                   "GBps": pull["GBps"], "get_ms": get_ms,
                   "transfer_ms": pull["transfer_ms"],
                   "store_write_ms": pull["store_write_ms"],
                   "address": pull["from"][0][1] if pull["from"] else None,
                   "device": t.device.type, "made_on": made["host"],
                   "hosts_before": before,
                   "sha_equal": tensor_sha(torch, t) == made["sha"]}
            out[plane].append(row)
            del t, made, inner
            if row["made_on"] != host or before != [host]:
                fail(f"19b: the {plane} tensor was made on {row['made_on']} "
                     f"and located on {before}, not on {host}")
            if not row["sha_equal"]:
                fail(f"19b: the {plane} pull's bytes differ from {host}'s")
            if row["device"] != "cuda":
                fail(f"19b: the {plane} pull landed on {row['device']}")
            if (plane == "native") != str(row["address"]).startswith(
                    "native:"):
                fail(f"19b: the {plane} pull read {row['address']}")
    for plane in ("native", "python"):
        rows = out[plane]
        print(f"19b {plane} plane on {card}: pull of {PULL_BYTES} B in "
              + ", ".join(f"{r['ms']:.3f}" for r in rows) + " ms ("
              + ", ".join(f"{r['GBps']:.3f}" for r in rows)
              + " GB/s; transfer "
              + ", ".join(f"{r['transfer_ms']:.3f}" for r in rows)
              + " ms, store write "
              + ", ".join(f"{r['store_write_ms']:.3f}" for r in rows)
              + " ms); get onto the card "
              + ", ".join(f"{r['get_ms']:.3f}" for r in rows) + " ms",
              flush=True)
    return out


def lose_host_19c(torch, rt, card: str, cluster, expected: dict,
                  prepare=None) -> dict:
    """19c: a prefill on host-1 whose host is lost mid-task is retried on
    host-0's GPU; host-1's node is dead, its node-leave event names the
    lost GPU, and a put object only host-1 held is lost."""
    from ray_tpu_torch._private.constants import EVENT_NODE_LEAVE
    from ray_tpu_torch.exceptions import ObjectLostError
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    on1 = NodeAffinitySchedulingStrategy(node_id="host-1")
    lost = rt.get(rt.remote(lost_object()).options(
        scheduling_strategy=on1).remote(), timeout=120)
    out = {"lost_hosts": object_hosts(rt, lost.hex())}
    flag = os.path.join(rt._private.api._node.session_dir, "prefill_started")
    task = rt.remote(num_gpus=1, max_retries=1)(
        retried_prefill(flag, prepare))
    ref = task.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id="host-1", soft=True)).remote()
    deadline = time.monotonic() + HOST_WAIT_S
    while not os.path.exists(flag) and time.monotonic() < deadline:
        time.sleep(0.05)
    if not os.path.exists(flag):
        fail("19c: the prefill never started on host-1")
    t_kill = time.perf_counter()
    cluster.remove_host("host-1")
    while time.perf_counter() - t_kill < 60:
        row = next(n for n in rt.nodes() if n["node_id"] == "host-1")
        if not row["alive"]:
            break
        time.sleep(0.01)
    out["detect_s"] = time.perf_counter() - t_kill
    res = rt.get(ref, timeout=HOST_WAIT_S)
    out["retried_result_s"] = time.perf_counter() - t_kill
    out.update({"host": res["host"], "token": res["token"],
                "launches": res["launches"]})
    left = [e for e in state.list_events(etype=EVENT_NODE_LEAVE)
            if e.get("node") == "host-1"]
    out["node_leave"] = {k: left[0].get(k) for k in
                         ("message", "reason", "lost_resources",
                          "n_workers_lost")} if left else None
    out["host1_alive"] = row["alive"]
    try:
        rt.get(lost, timeout=60)
        out["lost_get"] = None
    except ObjectLostError as e:
        out["lost_get"] = type(e).__name__
    except Exception as e:  # noqa: BLE001 — the wrong class fails below
        out["lost_get"] = f"{type(e).__name__}: {e}"
    if out["lost_hosts"] != ["host-1"]:
        fail(f"19c: the put object lived on {out['lost_hosts']}")
    if not left or left[0].get("lost_resources", {}).get("GPU") != 1.0:
        fail(f"19c: no node-leave event names host-1's GPU: {left}")
    if out["host1_alive"]:
        fail("19c: host-1 is alive in list_nodes after its loss")
    if res["host"] != "host-0":
        fail(f"19c: the retry ran on {res['host']}, not host-0")
    if res["token"] != expected["token"]:
        fail(f"19c: the retried prefill's token {res['token']} != "
             f"{expected['token']}")
    want = {"flash_attention_fwd_bf16": res["n_layers"]}
    for sym, n in res["launches"].items():
        if n != want.get(sym, 0):
            fail(f"19c: {sym} launched {n} times in the retry, expected "
                 f"{want.get(sym, 0)}")
    if out["lost_get"] != "ObjectLostError":
        fail(f"19c: get of host-1's only copy gave {out['lost_get']}")
    print(f"19c host loss on {card}: host-1 dead {out['detect_s']:.3f} s "
          f"after the kill, the retried prefill's token on host-0 "
          f"{out['retried_result_s']:.3f} s after it; the lost copy "
          f"raised {out['lost_get']}", flush=True)
    return out


def multihost_phase(torch, rt, card: str, expected: dict, fps10: dict,
                    prepare=None) -> dict:
    """Phase 19 in a fresh session with HOST_ENV: a head with one GPU, two
    follower hosts (node agents) each granted the card; 19a, 19b, 19c.
    After shutdown no segment of the session (host-1's namespace included)
    is left and the card's free memory is back."""
    import glob

    from ray_tpu_torch._private.ray_config import RayConfig
    from ray_tpu_torch.cluster_utils import Cluster

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in HOST_ENV}
    os.environ.update(HOST_ENV)
    RayConfig.reset()
    out = {}
    try:
        cluster = Cluster(head_node_args=dict(num_cpus=8, num_gpus=1))
        sid = out["session"] = rt._private.api._node.session_id
        t0 = time.perf_counter()
        cluster.add_host(host_id="host-1", num_cpus=2, num_gpus=1,
                         env=NATIVE_ENV)
        out["add_host_s"] = time.perf_counter() - t0
        out["19a"] = serve_from_follower_19a(torch, rt, card, expected,
                                             fps10, prepare)
        cluster.add_host(host_id="host-2", num_cpus=2, num_gpus=1)
        out["19b"] = both_planes_19b(torch, rt, card, prepare)
        cluster.remove_host("host-2")  # 19c's retry must land on host-0
        out["19c"] = lose_host_19c(torch, rt, card, cluster, expected,
                                   prepare)
    finally:
        rt.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        RayConfig.reset()
    left = glob.glob(f"/dev/shm/rtpt_{sid}*")
    if left:
        fail(f"19: shm segments of the session left: {sorted(left)}")
    gc.collect()
    torch.cuda.empty_cache()
    deadline = time.monotonic() + 30
    free = torch.cuda.mem_get_info()[0]
    while free0 - free > HOST_MEM_SLACK and time.monotonic() < deadline:
        time.sleep(0.5)
        free = torch.cuda.mem_get_info()[0]
    out["free_before"], out["free_after"] = free0, free
    if free0 - free > HOST_MEM_SLACK:
        fail(f"19: the card has {(free0 - free) / 2**30:.3f} GiB less free "
             f"memory after the phase")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"multi-host on {card}: phase 19 took {out['phase_s']:.1f} s",
          flush=True)
    return out


# ----------------------------------------------------------------- phase 20

PIP_PKG = "rtpt_probe_pkg"      # 20's local package, installed offline
ENV_PROBE = ("RTPT_PHASE20_PROBE", "pip-env")
ENV_WAIT_S = 300.0              # 20: an env actor's boot or serve call
# 20a and 20b serve the last 4 of phase 4's 8 prompts (700-1500 tokens;
# cut from all 8 to make room for 20c)
AS_PROMPTS = 4
AS_INTERVAL_S = 0.5             # 20b: the monitor's reconcile interval
# 20b and 20c: idle time before scale-down; cut from 10 s to make room
# for 20c
AS_IDLE_S = 3.0
AS_DRAIN_S = 1.0                # 20b: the drain window before terminate
# 20b: from the actor's kill to the node's termination, at most the idle
# timeout, the drain window, the agent's orderly stop and a few passes
AS_TERM_LIMIT_S = AS_IDLE_S + AS_DRAIN_S + 10.0 + 8 * AS_INTERVAL_S
GCE_MACHINE = "a3-highgpu-1g"   # 20c: the VM's machine type (one H100)
GCE_PROJECT, GCE_ZONE = "chip-smoke", "us-central1-a"   # 20c: the fake's
# 20c: the boot image the insert names; the fake boots nothing from it
GCE_IMAGE = f"projects/{GCE_PROJECT}/global/images/torch-h100"
GCE_SEED = SEED + 20            # 20c: the flash forward's inputs


def write_probe_pkg(root: str) -> str:
    """A tiny package that pip installs with no index: setuptools from the
    machine, no build isolation."""
    pkg = os.path.join(root, PIP_PKG)
    os.makedirs(os.path.join(pkg, PIP_PKG), exist_ok=True)
    with open(os.path.join(pkg, PIP_PKG, "__init__.py"), "w") as f:
        f.write('MAGIC = "probe-0.1.0"\n')
    with open(os.path.join(pkg, "pyproject.toml"), "w") as f:
        f.write('[build-system]\nrequires = ["setuptools"]\n'
                'build-backend = "setuptools.build_meta"\n'
                '[project]\nname = "rtpt-probe-pkg"\nversion = "0.1.0"\n')
    return pkg


def pip_env(pkg: str) -> dict:
    return {"pip": ["--no-index", "--no-build-isolation", pkg],
            "env_vars": {ENV_PROBE[0]: ENV_PROBE[1]}}


def env_server(prepare=None):
    """20's actor class (``num_gpus=1``, in a pip env): ``where`` reports
    the interpreter's prefix, the package, the env var, the card and the
    host; ``serve`` runs ``follower_serve``'s body (Llama-3-8B from the
    seed, 18a's prefill, phase 4's prompts served greedily) with the
    engine's ``generate`` wrapped to note the wall time of its first
    token."""

    class EnvServer:
        def where(self):
            if prepare is not None:
                prepare()
            import importlib

            import torch

            pkg = importlib.import_module(PIP_PKG)
            return {"prefix": sys.prefix, "magic": pkg.MAGIC,
                    "env": os.environ.get(ENV_PROBE[0]),
                    "device": torch.cuda.get_device_name(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "torch": torch.__file__, "host": host_id(),
                    "pid": os.getpid()}

        def serve(self):
            import torch

            from ray_tpu_torch.llm import LLMEngine

            first = {}
            plain_generate = LLMEngine.generate

            def generate(eng, token_ids, params=None, *, lora=None):
                out = []
                for t in eng.stream(token_ids, params, lora=lora):
                    first.setdefault("t", time.time())
                    out.append(t)
                return out

            LLMEngine.generate = generate
            t0 = time.time()
            try:
                res = follower_serve(prepare, AS_PROMPTS)()
            finally:
                LLMEngine.generate = plain_generate
            out = {k: res[k] for k in ("ids", "fingerprints", "launches",
                                       "prefills", "decode_steps",
                                       "n_layers", "host", "hashes")}
            out.update(token=int(torch.argmax(res["logits"])), t_start=t0,
                       t_first_token=first.get("t"), t_done=time.time())
            del res
            gc.collect()
            torch.cuda.empty_cache()
            return out

    return EnvServer


def env_get(rt, ref, tag: str, timeout: float = ENV_WAIT_S):
    """``rt.get(ref)`` that fails the phase at once when a runtime-env
    agent of the session (the head's or a follower's) reports a failed
    build: the env's worker exits before it registers, and the actor would
    otherwise wait for its spawn's whole budget."""
    import glob

    from ray_tpu_torch._private.protocol import connect_unix

    node = rt._private.api._node
    deadline = time.monotonic() + timeout
    while True:
        ready, _ = rt.wait([ref], num_returns=1, timeout=1.0)
        if ready:
            return rt.get(ref, timeout=60)
        for sock in glob.glob(os.path.join(node.session_dir, "renv_agent.sock")) \
                + glob.glob(os.path.join(node.session_dir, "agent_*",
                                         "renv_agent.sock")):
            try:
                conn = connect_unix(sock, timeout=5.0)
                try:
                    conn.send({"t": "list", "rid": 1})
                    envs = conn.recv().get("envs") or {}
                finally:
                    conn.close()
            except OSError:
                continue
            bad = [e.get("error") for e in envs.values()
                   if e.get("state") == "failed"]
            if bad:
                fail(f"{tag}: the runtime env failed to build: {bad[0]}")
                raise RuntimeError(bad[0])
        if time.monotonic() > deadline:
            fail(f"{tag}: no result {timeout:.0f} s after the call")
            raise TimeoutError(tag)


def check_served(tag: str, res: dict, expected: dict, fps10: dict,
                 driver_launches: dict) -> None:
    """20a's and 20b's gates on a served result: phase 10's weights, the
    in-process token, KV and logits bytes and the last AS_PROMPTS prompts'
    ids, and the launches of
    both serving kernels in the actor's worker, none in the driver."""
    if res["fingerprints"] != fps10:
        fail(f"{tag}: the actor's weights differ from phase 10's")
    if res["token"] != expected["token"]:
        fail(f"{tag}: greedy token {res['token']} != in-process prefill's "
             f"{expected['token']}")
    if res["hashes"] != expected["hashes"]:
        fail(f"{tag}: KV or logits differ from in-process prefill's bytes")
    want_ids = expected["ids"][-AS_PROMPTS:]
    if res["ids"] != want_ids:
        bad = [i for i, (a, b) in enumerate(zip(res["ids"], want_ids))
               if a != b or len(res["ids"]) != len(want_ids)]
        fail(f"{tag}: the actor's ids differ from in-process serving at "
             f"prompts {bad} of the last {AS_PROMPTS}")
    L = res["n_layers"]
    want = {"flash_attention_fwd_bf16": L * (1 + res["prefills"]),
            "ragged_paged_attention_bf16": L * res["decode_steps"]}
    for sym, n in res["launches"].items():
        if n != want.get(sym, 0):
            fail(f"{tag}: {sym} launched {n} times in the actor's worker, "
                 f"expected {want.get(sym, 0)}")
    if any(driver_launches.values()):
        fail(f"{tag}: launches in the driver: {driver_launches}")


def pip_env_20a(torch, rt, card: str, expected: dict, fps10: dict,
                pkg: str, prepare=None) -> dict:
    """20a: a pip env on the head's GPU. The venv is built (no index) by
    the head's runtime-env agent when the first actor boots; that actor
    serves Llama-3-8B; a second actor of the same spec boots from the
    cache; a plain task does not see the package."""
    from ray_tpu_torch._private import runtime_env_pip as rep

    renv = pip_env(pkg)
    h = rep.pip_hash(renv["pip"])
    venv = os.path.join(rep.venv_base(), h)
    lock = os.path.join(rep.venv_base(), f".{h}.lock")
    marker = os.path.join(venv, ".ready")
    import shutil

    shutil.rmtree(venv, ignore_errors=True)  # a build, not a leftover
    Server = rt.remote(num_gpus=1, runtime_env=renv)(env_server(prepare))
    kernels = loop_kernels()
    zero(kernels)  # the main path starts here
    t0 = time.perf_counter()
    a = Server.remote()
    where = env_get(rt, a.where.remote(), "20a")
    out = {"ready_s": time.perf_counter() - t0, "where": where}
    if not os.path.exists(marker):
        fail(f"20a: no venv was built at {venv}")
    out["build_s"] = os.path.getmtime(marker) - os.path.getmtime(lock)
    res = env_get(rt, a.serve.remote(), "20a")
    out["driver_launches"] = counts(kernels)
    rt.kill(a)
    check_served("20a", res, expected, fps10, out["driver_launches"])
    out.update({k: res[k] for k in ("launches", "prefills", "decode_steps",
                                    "host", "token")})
    out["serve_s"] = res["t_done"] - res["t_start"]
    out["first_token_s"] = res["t_first_token"] - res["t_start"]
    built = os.path.getmtime(marker)
    t1 = time.perf_counter()
    b = Server.remote()
    cached = env_get(rt, b.where.remote(), "20a")
    out["cached_ready_s"] = time.perf_counter() - t1
    rt.kill(b)
    out["cached"] = cached

    def plain():
        import importlib

        try:
            importlib.import_module(PIP_PKG)
            return "leaked"
        except ImportError:
            return "clean"

    out["plain_task"] = rt.get(rt.remote(plain).remote(), timeout=120)
    for name, w in (("first", where), ("second", cached)):
        if os.path.realpath(w["prefix"]) != os.path.realpath(venv):
            fail(f"20a: the {name} actor ran under {w['prefix']}, not the "
                 f"venv {venv}")
        if w["magic"] != "probe-0.1.0" or w["env"] != ENV_PROBE[1]:
            fail(f"20a: the {name} actor saw {w['magic']!r}, "
                 f"{ENV_PROBE[0]}={w['env']!r}")
        if w["device"] != torch.cuda.get_device_name(0):
            fail(f"20a: the {name} actor's card is {w['device']}")
        if w["host"] != "host-0":
            fail(f"20a: the {name} actor ran on {w['host']}")
    if os.path.getmtime(marker) != built:
        fail("20a: the second actor rebuilt the venv")
    if out["plain_task"] != "clean":
        fail("20a: a plain task imported the pip env's package")
    print(f"20a llama-3-8b from a pip-env actor on {card}: venv built in "
          f"{out['build_s']:.3f} s (the actor ready {out['ready_s']:.3f} s "
          f"after it was made), cached boot {out['cached_ready_s']:.3f} s; "
          f"first token {out['first_token_s']:.3f} s into serve, serve "
          f"{out['serve_s']:.3f} s, {len(res['ids'])} prompts token-exact; "
          f"torch from {where['torch']}", flush=True)
    return out


class InstanceWatch:
    """20b's view of the GCS's instance table: a thread reads it every
    20 ms through the driver's worker and notes when each instance was
    first seen in each state, with its record."""

    def __init__(self, rt):
        import threading

        self.worker = rt._private.api._get_worker()
        self.seen: dict = {}      # instance id → [(state, wall time)]
        self.records: dict = {}   # instance id → last record
        self.errors: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(0.02):
            try:
                recs = self.worker.rpc({"type": "instance_list"})["instances"]
            except Exception as e:  # noqa: BLE001 — reported by the phase
                self.errors.append(repr(e))
                return
            now = time.time()
            ids = set()
            for r in recs:
                iid = r["instance_id"]
                ids.add(iid)
                self.records[iid] = r
                states = self.seen.setdefault(iid, [])
                if not states or states[-1][0] != r["state"]:
                    states.append((r["state"], now))
            for iid, states in self.seen.items():
                if iid not in ids and states[-1][0] != "TERMINATED":
                    states.append(("TERMINATED", now))

    def first(self, state: str):
        for states in self.seen.values():
            for s, t in states:
                if s == state:
                    return t
        return None

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


def transitions_counted(rt) -> dict:
    """``ray_tpu_autoscaler_instance_transitions_total`` in the GCS's
    snapshot (the monitor flushes its registry after each pass), by
    (from, to)."""
    snap = rt._private.api._get_worker().rpc(
        {"type": "metrics_snapshot"})["metrics"]
    rec = snap.get("ray_tpu_autoscaler_instance_transitions_total") or {}
    out: dict = {}
    for series in (rec.get("series") or {}).values():
        for tags, value in series:
            t = dict(tuple(kv) for kv in tags)
            key = f"{t.get('from_state')}->{t.get('to_state')}"
            out[key] = out.get(key, 0.0) + value
    return out


def host_processes(host: str) -> list:
    """Live processes of follower `host`: its agent (``--host-id`` in its
    argv) and whatever carries its host id in its environment."""
    from ray_tpu_torch.autoscaler.node_provider import _pid_alive

    tag, env = host.encode(), f"RAY_TPU_TORCH_HOST_ID={host}".encode()
    out = []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            with open(f"/proc/{p}/environ", "rb") as f:
                environ = f.read().split(b"\0")
        except OSError:
            continue
        if (tag in argv or env in environ) and _pid_alive(int(p)):
            out.append(int(p))
    return out


def autoscaled_20b(torch, rt, card: str, expected: dict, fps10: dict,
                   pkg: str, prepare=None) -> dict:
    """20b in a fresh session whose head has no GPU: the monitor (provider
    ``local``, node type ``gpu`` = {CPU: 2, GPU: 1}, at most one) launches
    a follower host for a pending ``num_gpus=1`` pip-env actor; the
    follower's own runtime-env agent builds the venv (a base of its own);
    the actor serves Llama-3-8B there; once it is killed the node idles,
    drains and is terminated."""
    import glob
    import tempfile

    from ray_tpu_torch._private.constants import (EVENT_AUTOSCALER_INSTANCE,
                                                  temp_root)
    from ray_tpu_torch._private.protocol import connect_unix
    from ray_tpu_torch.autoscaler.node_provider import _pid_alive
    from ray_tpu_torch.util import state

    out = {}
    rt.init(num_cpus=4, num_gpus=0)
    node = rt._private.api._node
    sid = out["session"] = node.session_id
    work = tempfile.mkdtemp(prefix="phase20b_", dir=node.session_dir)
    cfg = {"provider": {"type": "local"},
           "node_types": {"gpu": {"resources": {"CPU": 2, "GPU": 1},
                                  "max_nodes": 1}},
           "interval_s": AS_INTERVAL_S, "idle_timeout_s": AS_IDLE_S}
    cfg_path = os.path.join(work, "autoscaling.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    follower_base = os.path.join(work, "venvs")
    env = dict(os.environ, RAY_TPU_TORCH_VENV_BASE=follower_base,
               RAY_TPU_TORCH_DRAIN_GRACE_S=str(AS_DRAIN_S))
    log = open(os.path.join(node.session_dir, "logs", "monitor.log"), "ab")
    try:
        monitor = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.monitor",
             "--address", node.address, "--autoscaling-config", cfg_path],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=HERE,
            start_new_session=True)
    finally:
        log.close()
    watch = None
    try:
        deadline = time.monotonic() + 60
        while not node.gcs._autoscaler_conns:
            if monitor.poll() is not None or time.monotonic() > deadline:
                fail(f"20b: the monitor never attached (exit "
                     f"{monitor.poll()}; see monitor.log)")
            time.sleep(0.05)
        watch = InstanceWatch(rt)
        Server = rt.remote(num_gpus=1, runtime_env=pip_env(pkg))(
            env_server(prepare))
        kernels = loop_kernels()
        zero(kernels)  # the main path starts here
        t_submit = time.time()
        a = Server.remote()
        where = env_get(rt, a.where.remote(), "20b")
        t_ready = time.time()
        host = where["host"]
        joined = [e for e in state.list_events(etype="node.join")
                  if e.get("node") == host]
        res = env_get(rt, a.serve.remote(), "20b")
        out["driver_launches"] = counts(kernels)
        check_served("20b", res, expected, fps10, out["driver_launches"])
        sock = os.path.join(temp_root(), f"session_{sid}", f"agent_{host}",
                            "renv_agent.sock")
        conn = connect_unix(sock, timeout=10.0)
        try:
            conn.send({"t": "list", "rid": 1})
            out["follower_agent_envs"] = conn.recv()["envs"]
        finally:
            conn.close()
        agent_pid = next((r.get("provider_data") or {}).get("pid")
                         for r in watch.records.values())
        free_mid = torch.cuda.mem_get_info()[0]
        t_kill = time.time()
        rt.kill(a)
        deadline = time.monotonic() + AS_TERM_LIMIT_S + 30
        while watch.first("TERMINATED") is None:
            if time.monotonic() > deadline or watch.errors:
                fail(f"20b: the node was not terminated "
                     f"{AS_TERM_LIMIT_S + 30:.0f} s after the kill: "
                     f"{watch.seen} {watch.errors}")
            time.sleep(0.05)
        t_term = watch.first("TERMINATED")
        deadline = time.monotonic() + 10
        while transitions_counted(rt).get("TERMINATING->TERMINATED", 0) < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        out["transitions_counted"] = transitions_counted(rt)
        out["left_processes"] = host_processes(host)
        out["left_segments"] = sorted(glob.glob(f"/dev/shm/rtpt_{sid}_{host}*"))
        out["agent_alive"] = bool(agent_pid) and _pid_alive(int(agent_pid))
        gc.collect()
        torch.cuda.empty_cache()
        out["free_after_term"] = torch.cuda.mem_get_info()[0]
        out["free_mid"] = free_mid
        out["node_alive"] = next((n["alive"] for n in rt.nodes()
                                  if n["node_id"] == host), None)
        events = state.list_events(etype=EVENT_AUTOSCALER_INSTANCE)
    finally:
        if watch is not None:
            watch.close()
        monitor.terminate()
        try:
            monitor.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(monitor.pid, 9)
            monitor.wait(timeout=10)
        rt.shutdown()
    # each instance_put the GCS took is an event (REQUESTED lasts only
    # within one pass); the record's deletion is TERMINATED
    trans = sorted((e["ts"], e.get("from_state"), e.get("to_state"))
                   for e in events
                   if e.get("instance_id") in watch.seen)
    states = [to for _, _, to in trans] + ["TERMINATED"]
    out["states"] = states
    at = {}
    for ts, _, to in trans:
        at.setdefault(to, ts)
    t_alloc = at.get("ALLOCATED")
    t_join = joined[0]["ts"] if joined else None
    t_idle = at.get("IDLE_TRACKED") or t_kill
    out.update({
        "host": host, "where": where,
        "launches": res["launches"], "prefills": res["prefills"],
        "decode_steps": res["decode_steps"], "token": res["token"],
        "demand_to_create_s": t_alloc - t_submit,
        "demand_to_join_s": (t_join - t_submit) if t_join else None,
        "demand_to_ready_s": t_ready - t_submit,
        "demand_to_first_token_s": res["t_first_token"] - t_submit,
        "kill_to_idle_s": t_idle - t_kill,
        "idle_to_terminated_s": t_term - t_idle,
        "kill_to_terminated_s": t_term - t_kill,
        "monitor_exit": monitor.returncode})
    if not host.startswith("as-gpu-"):
        fail(f"20b: the actor ran on {host}, not an autoscaled host")
    if t_join is None:
        fail(f"20b: no node.join event for {host}")
    if os.path.commonpath([os.path.realpath(where["prefix"]),
                           os.path.realpath(follower_base)]) != \
            os.path.realpath(follower_base):
        fail(f"20b: the actor ran under {where['prefix']}, not a venv of "
             f"the follower's base {follower_base}")
    envs = out["follower_agent_envs"]
    if len(envs) != 1 or next(iter(envs.values()))["state"] != "ready":
        fail(f"20b: the follower's runtime-env agent holds {envs}")
    if where["env"] != ENV_PROBE[1] or where["magic"] != "probe-0.1.0":
        fail(f"20b: the actor saw {where['magic']!r}, "
             f"{ENV_PROBE[0]}={where['env']!r}")
    want_states = ["REQUESTED", "ALLOCATED", "RUNNING", "IDLE_TRACKED",
                   "DRAINING", "TERMINATING", "TERMINATED"]
    if list(dict.fromkeys(states)) != want_states:
        fail(f"20b: the instance table showed {states}")
    for key in ("(new)->REQUESTED", "REQUESTED->ALLOCATED",
                "ALLOCATED->RUNNING", "RUNNING->IDLE_TRACKED",
                "IDLE_TRACKED->DRAINING", "DRAINING->TERMINATING",
                "TERMINATING->TERMINATED"):
        if out["transitions_counted"].get(key, 0) < 1:
            fail(f"20b: no {key} in the transitions counter: "
                 f"{out['transitions_counted']}")
    if out["kill_to_terminated_s"] > AS_TERM_LIMIT_S:
        fail(f"20b: terminated {out['kill_to_terminated_s']:.1f} s after "
             f"the kill (limit {AS_TERM_LIMIT_S:.1f})")
    if out["left_processes"] or out["agent_alive"]:
        fail(f"20b: processes of {host} left: {out['left_processes']}")
    if out["left_segments"]:
        fail(f"20b: segments of {host} left: {out['left_segments']}")
    if out["node_alive"]:
        fail(f"20b: {host} is alive in list_nodes after its termination")
    if out["monitor_exit"] != 0:
        fail(f"20b: the monitor exited {out['monitor_exit']}")
    print(f"20b llama-3-8b on an autoscaled host ({host}) on {card}: "
          f"demand to create_node {out['demand_to_create_s']:.3f} s",
          flush=True)
    print(f"20b demand to the node joining "
          f"{out['demand_to_join_s']:.3f} s", flush=True)
    print(f"20b demand to the actor ready "
          f"{out['demand_to_ready_s']:.3f} s", flush=True)
    print(f"20b demand to the first token "
          f"{out['demand_to_first_token_s']:.3f} s ({len(res['ids'])} "
          f"prompts token-exact)", flush=True)
    print(f"20b idle to terminated {out['idle_to_terminated_s']:.3f} s "
          f"(kill to idle {out['kill_to_idle_s']:.3f} s; states "
          f"{' > '.join(states)})", flush=True)
    return out


class FakeCompute:
    """20c's Compute Engine: a fake of compute.googleapis.com v1's
    instances (insert, delete, list, get) and zone operations, as a
    transport for ``RestGceGpuApi``. An insert runs the request's
    ``startup-script`` value unchanged under bash in a process group of its
    own, with ``python`` on PATH the running interpreter; a delete SIGKILLs
    that group, as a deleted VM loses everything on it. A VM reports
    RUNNING from its insert to its delete, whatever its script does. Every
    call is recorded with its wall time."""

    def __init__(self, bin_dir: str, log_dir: str):
        import threading

        self.bin_dir = bin_dir
        self.log_dir = log_dir
        self.vms: dict = {}       # name → Popen of its startup script
        self.scripts: dict = {}   # name → the script it ran
        self.images: dict = {}    # name → its boot disk's source image
        self.calls: list = []     # (wall time, method, path below the zone)
        self.deleted: dict = {}   # name → wall time of its delete
        self.n_ops = 0
        self._lock = threading.Lock()

    def _reply(self, obj, status: int = 200):
        return status, json.dumps(obj).encode()

    def __call__(self, method, url, headers, body, timeout):
        zone = f"/projects/{GCE_PROJECT}/zones/{GCE_ZONE}/"
        if zone not in url or headers.get("Authorization") != "Bearer token":
            return self._reply({"error": {"message": f"bad call {url}"}}, 400)
        tail = url.split(zone, 1)[1].split("?", 1)[0]
        parts = tail.split("/")
        with self._lock:
            self.calls.append((time.time(), method, tail))
            if parts[0] == "operations":
                return self._reply({"name": parts[1], "status": "DONE"})
            if method == "POST":
                req = json.loads(body)
                name = req["name"]
                script, = [i["value"] for i in req["metadata"]["items"]
                           if i["key"] == "startup-script"]
                log = open(os.path.join(self.log_dir, f"vm-{name}.log"), "ab")
                try:
                    self.vms[name] = subprocess.Popen(
                        ["bash", "-c", script], cwd=HERE, stdout=log,
                        stderr=subprocess.STDOUT, start_new_session=True,
                        env=dict(os.environ, PATH=os.pathsep.join(
                            [self.bin_dir, os.environ.get("PATH", "")])))
                finally:
                    log.close()
                self.scripts[name] = script
                self.images[name] = [d["initializeParams"]["sourceImage"]
                                     for d in req["disks"] if d["boot"]]
                self.n_ops += 1
                return self._reply({"name": f"operation-{self.n_ops}",
                                    "operationType": "insert",
                                    "status": "RUNNING"})
            if len(parts) == 1:  # instances.list
                return self._reply({"items": [
                    {"name": n, "status": "RUNNING"} for n in self.vms]})
            p = self.vms.get(parts[1])
            if p is None:
                return self._reply({"error": {
                    "message": f"instance {parts[1]} not found",
                    "errors": [{"reason": "notFound"}]}}, 404)
            if method == "DELETE":
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except OSError:
                    pass
                p.wait(timeout=30)
                del self.vms[parts[1]]
                self.deleted[parts[1]] = time.time()
                self.n_ops += 1
                return self._reply({"name": f"operation-{self.n_ops}",
                                    "operationType": "delete",
                                    "status": "DONE"})
            return self._reply({"name": parts[1], "status": "RUNNING"})


def python_on_path(bin_dir: str) -> None:
    """``<bin_dir>/python`` runs this interpreter: an exec wrapper, since a
    symlink to a virtualenv's interpreter loses the virtualenv."""
    os.makedirs(bin_dir, exist_ok=True)
    path = os.path.join(bin_dir, "python")
    with open(path, "w") as f:
        f.write(f'#!/bin/sh\nexec {sys.executable} "$@"\n')
    os.chmod(path, 0o755)


class VmFlash:
    """20c's actor (``num_gpus=1``): the flash forward on 13b's shape and
    seeded inputs, with this worker's launch counts and host."""

    def __init__(self, prepare=None):
        if prepare is not None:
            prepare()

    def run(self, seed: int) -> dict:
        import torch

        from ray_tpu_torch.ops import _build
        from ray_tpu_torch.ops import flash_attention as fa

        built = _build.build_all([fa.KERNEL.source])
        kernels = loop_kernels()
        (q, k, v), _ = kernel_inputs(torch, seed)
        zero(kernels)
        o, lse = fa._fwd_call(q, k, v, causal=True, scale=q.shape[-1] ** -0.5)
        torch.cuda.synchronize()
        return {"o": o, "lse": lse, "launches": counts(kernels),
                "host": host_id(), "nvcc_built": sorted(built),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_name": torch.cuda.get_device_name(0)}


def rest_calls(calls: list, t0: float) -> list:
    """The REST calls in order, repeats of one call folded into a count:
    [method, path, count, seconds after t0 of the first]."""
    out = []
    for t, method, path in calls:
        if out and out[-1][:2] == [method, path]:
            out[-1][2] += 1
        else:
            out.append([method, path, 1, round(t - t0, 3)])
    return out


def gce_vm_20c(torch, rt, card: str, prepare=None) -> dict:
    """20c in a fresh session whose head has no GPU: an in-process
    Autoscaler over the GCE GPU provider and its REST client, whose
    transport is FakeCompute; a pending num_gpus=1 actor lands on the VM's
    host and runs the flash forward; once it is killed the VM drains and
    is deleted."""
    import glob
    import tempfile

    from ray_tpu_torch._private.constants import EVENT_AUTOSCALER_INSTANCE
    from ray_tpu_torch.autoscaler import (Autoscaler, GceGpuNodeProvider,
                                          gpu_vm_node_type)
    from ray_tpu_torch.autoscaler.gce_rest import RestGceGpuApi
    from ray_tpu_torch.autoscaler.node_provider import AGENT_MODULE
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.util import state

    out = {}
    info = rt.init(num_cpus=4, num_gpus=0)
    sid = out["session"] = info["session_id"]
    node = rt._private.api._node
    work = tempfile.mkdtemp(prefix="phase20c_", dir=node.session_dir)
    python_on_path(os.path.join(work, "bin"))
    cloud = FakeCompute(os.path.join(work, "bin"),
                        os.path.join(node.session_dir, "logs"))
    rest = RestGceGpuApi(GCE_PROJECT, GCE_ZONE, source_image=GCE_IMAGE,
                         transport=cloud,
                         token_provider=lambda: "token",
                         gcs_address=node.address, op_poll_s=0.2)
    provider = GceGpuNodeProvider(rest, project=GCE_PROJECT, zone=GCE_ZONE,
                                  gcs_address=node.address,
                                  cluster_name="chip")
    nt = gpu_vm_node_type(GCE_MACHINE, cpus=2, max_nodes=1)
    scaler = None
    try:
        scaler = Autoscaler(f"unix:{node.socket_path}", provider, [nt],
                            interval_s=AS_INTERVAL_S,
                            idle_timeout_s=AS_IDLE_S,
                            drain_grace_s=AS_DRAIN_S).start()
        kernels = loop_kernels()
        zero(kernels)  # the main path starts here
        t_submit = time.time()
        a = rt.remote(num_gpus=1)(VmFlash).remote(prepare)
        res = rt.get(a.run.remote(GCE_SEED), timeout=ENV_WAIT_S)
        t_result = time.time()
        out["driver_launches"] = counts(kernels)
        host = res["host"]
        joined = [e for e in state.list_events(etype="node.join")
                  if e.get("node") == host]
        vm = host.removesuffix("-w0")
        t_kill = time.time()
        rt.kill(a)
        deadline = time.monotonic() + AS_TERM_LIMIT_S + 30
        while vm not in cloud.deleted:
            if time.monotonic() > deadline:
                fail(f"20c: the VM {vm} was not deleted "
                     f"{AS_TERM_LIMIT_S + 30:.0f} s after the kill")
                break
            time.sleep(0.05)
        deadline = time.monotonic() + 10
        while host_processes(host) and time.monotonic() < deadline:
            time.sleep(0.1)  # SIGKILLed: the reparented children are reaped
        out["left_processes"] = host_processes(host)
        events = state.list_events(etype=EVENT_AUTOSCALER_INSTANCE)
    finally:
        if scaler is not None:
            scaler.stop()
        rt.shutdown()
    out["left_segments"] = sorted(glob.glob(f"/dev/shm/rtpt_{sid}*"))
    out["left_vms"] = sorted(cloud.vms)
    # the plain version on the same seeded inputs, on the driver's card
    (q, k, v), _ = kernel_inputs(torch, GCE_SEED)
    o_ref, lse_ref = fa.flash_attention_forward_plain(
        q.float(), k.float(), v.float(), causal=True,
        scale=q.shape[-1] ** -0.5)
    o_ref = o_ref.to(torch.bfloat16).float()
    o, lse = res["o"], res["lse"]
    calls = rest_calls(cloud.calls, t_submit)
    inserts = [c for c in cloud.calls if c[1] == "POST"]
    deletes = [c for c in cloud.calls if c[1] == "DELETE"]
    t_insert = inserts[0][0] if inserts else None
    t_join = joined[0]["ts"] if joined else None
    out.update({
        "vm": vm, "host": host, "machine_type": GCE_MACHINE,
        "node_type": nt.name, "node_resources": nt.resources,
        "launches": res["launches"], "nvcc_built": res["nvcc_built"],
        "visible": res["visible"], "device_name": res["device_name"],
        "startup_script": cloud.scripts.get(vm), "rest_calls": calls,
        "max_abs_err": (o.float() - o_ref).abs().max().item(),
        "lse_max_abs_err": (lse - lse_ref).abs().max().item(),
        "demand_to_insert_s": (t_insert - t_submit) if t_insert else None,
        "demand_to_join_s": (t_join - t_submit) if t_join else None,
        "demand_to_result_s": t_result - t_submit,
        "kill_to_delete_s": (cloud.deleted[vm] - t_kill
                             if vm in cloud.deleted else None),
        "instance_states": [e.get("to_state") for e in sorted(
            events, key=lambda e: e["ts"])]})
    want_script = (f"python -m {AGENT_MODULE} --address {node.address} "
                   f"--host-id {vm}-w0")
    if not vm.startswith(f"ray--chip--{nt.name}-"):
        fail(f"20c: the actor ran on {host}, not on a VM's host")
    if len(inserts) != 1 or len(deletes) != 1 or \
            not deletes[0][2].endswith(f"instances/{vm}"):
        fail(f"20c: inserts {inserts}, deletes {deletes}: one insert and "
             f"one delete of {vm} were expected")
    if cloud.images.get(vm) != [GCE_IMAGE]:
        fail(f"20c: the VM's boot disks {cloud.images.get(vm)} are not "
             f"[{GCE_IMAGE!r}]")
    if want_script not in (out["startup_script"] or ""):
        fail(f"20c: the VM's startup script {out['startup_script']!r} does "
             f"not run {want_script!r}")
    polls = [c for c in cloud.calls if c[2].startswith("operations/")]
    if not polls or polls[0][0] < t_insert:
        fail(f"20c: the insert's operation was not polled: {calls}")
    if t_join is None:
        fail(f"20c: no node.join event for {host}")
    if not (isinstance(o, torch.Tensor) and o.is_cuda):
        fail(f"20c: the forward came back as {type(o).__name__}")
    if not torch.isfinite(o.float()).all():
        fail("20c: non-finite output")
    if not torch.allclose(o.float(), o_ref, atol=ATOL, rtol=RTOL):
        fail(f"20c: max abs err {out['max_abs_err']} beyond atol = rtol = "
             f"{ATOL}")
    if out["lse_max_abs_err"] > LSE_TOL:
        fail(f"20c: lse err {out['lse_max_abs_err']} beyond {LSE_TOL}")
    del q, k, v, o_ref, lse_ref, o, lse, res
    want = {s: 0 for s in out["launches"]}
    want["flash_attention_fwd_bf16"] = 1
    if out["launches"] != want:
        fail(f"20c: the actor launched {out['launches']}, expected {want}")
    if any(out["driver_launches"].values()):
        fail(f"20c: launches in the driver: {out['driver_launches']}")
    if out["kill_to_delete_s"] is not None and \
            out["kill_to_delete_s"] > AS_TERM_LIMIT_S:
        fail(f"20c: deleted {out['kill_to_delete_s']:.1f} s after the kill "
             f"(limit {AS_TERM_LIMIT_S:.1f})")
    if out["left_processes"]:
        fail(f"20c: processes of {vm} left: {out['left_processes']}")
    if out["left_segments"] or out["left_vms"]:
        fail(f"20c: left after shutdown: segments {out['left_segments']}, "
             f"VMs {out['left_vms']}")
    print(f"20c REST calls: " + ", ".join(
        f"{m} {p}" + (f" x{n}" if n > 1 else "") + f" (+{t:.3f} s)"
        for m, p, n, t in calls), flush=True)
    print(f"20c flash forward on a GCE VM's host ({host}, "
          f"{GCE_MACHINE}) on {card}: demand to insert "
          f"{out['demand_to_insert_s']:.3f} s, to the join "
          f"{out['demand_to_join_s']:.3f} s, to the result "
          f"{out['demand_to_result_s']:.3f} s; max abs err "
          f"{out['max_abs_err']:.3g}, lse {out['lse_max_abs_err']:.3g}; "
          f"kill to delete {out['kill_to_delete_s']:.3f} s", flush=True)
    return out


def autoscaler_phase(torch, rt, card: str, expected: dict, fps10: dict,
                     prepare=None) -> dict:
    """Phase 20: 20a in a fresh session with one GPU, 20b and 20c in
    others with none. After each, no segment of its session is left; after
    all three, the card's free memory is back within HOST_MEM_SLACK."""
    import glob
    import tempfile

    from ray_tpu_torch._private.ray_config import RayConfig

    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in HOST_ENV}
    os.environ.update(HOST_ENV)
    RayConfig.reset()
    out = {}
    pkg = write_probe_pkg(tempfile.mkdtemp(prefix="phase20_pkg_"))
    try:
        t0 = time.perf_counter()
        info = rt.init(num_cpus=8, num_gpus=1)
        sid = info["session_id"]
        try:
            out["20a"] = pip_env_20a(torch, rt, card, expected, fps10, pkg,
                                     prepare)
        finally:
            rt.shutdown()
        left = glob.glob(f"/dev/shm/rtpt_{sid}*")
        if left:
            fail(f"20a: shm segments of the session left: {sorted(left)}")
        out["20a"]["sub_phase_s"] = time.perf_counter() - t0
        print(f"20a took {out['20a']['sub_phase_s']:.1f} s", flush=True)
        t0 = time.perf_counter()
        out["20b"] = autoscaled_20b(torch, rt, card, expected, fps10, pkg,
                                    prepare)
        left = glob.glob(f"/dev/shm/rtpt_{out['20b']['session']}*")
        if left:
            fail(f"20b: shm segments of the session left: {sorted(left)}")
        out["20b"]["sub_phase_s"] = time.perf_counter() - t0
        print(f"20b took {out['20b']['sub_phase_s']:.1f} s", flush=True)
        t0 = time.perf_counter()
        out["20c"] = gce_vm_20c(torch, rt, card, prepare)
        out["20c"]["sub_phase_s"] = time.perf_counter() - t0
        print(f"20c took {out['20c']['sub_phase_s']:.1f} s", flush=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        RayConfig.reset()
    gc.collect()
    torch.cuda.empty_cache()
    deadline = time.monotonic() + 30
    free = torch.cuda.mem_get_info()[0]
    while free0 - free > HOST_MEM_SLACK and time.monotonic() < deadline:
        time.sleep(0.5)
        free = torch.cuda.mem_get_info()[0]
    out["free_before"], out["free_after"] = free0, free
    if free0 - free > HOST_MEM_SLACK:
        fail(f"20: the card has {(free0 - free) / 2**30:.3f} GiB less free "
             f"memory after the phase")
    if free0 - out["20b"]["free_after_term"] > HOST_MEM_SLACK:
        fail(f"20b: the card has {(free0 - out['20b']['free_after_term']) / 2**30:.3f} "
             f"GiB less free memory after the node's termination")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"runtime envs and the autoscaler on {card}: phase 20 took "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------- phase 21

JOB_LINE = "PHASE21_JOB "        # prefix of the 21b job's JSON lines
JOB_WAIT_S = 900.0               # 21b: the job's app up and its 8 requests
JOB_MEM_SLACK = 1 << 30          # 21d: the card's free memory after the app
PROFILE_S = 2.0                  # 21c: the replica's profile during a wave
# 21e: each core record's timing window (cut from 0.5 s for 20c)
MICROBENCH_MIN_S = 0.25
CLI_TIMEOUT_S = 300.0


def job_main(argv=None) -> int:
    """The driver of phase 21's job, run by the entrypoint 21b writes, in a
    process the job supervisor started: it joins the session from
    RAY_TPU_TORCH_ADDRESS, deploys phase 14's app (the probing subclass
    defined in ``probe_server``, so it pickles by value), serves phase 14's
    8 prompts one at a time over HTTP and prints one JSON line; then waits
    for the release file, prints the replica's final probe and its own
    launch counts, and deletes the app."""
    ap = argparse.ArgumentParser(prog="chip_smoke job")
    ap.add_argument("--release", required=True)
    ap.add_argument("--prepare", default=None,
                    help="module:function applied in the replica (a CPU "
                         "rehearsal's patches)")
    args = ap.parse_args(argv)
    prepare = None
    if args.prepare:
        import importlib

        mod, _, fn = args.prepare.partition(":")
        prepare = getattr(importlib.import_module(mod), fn)
    t0 = time.time()
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import (LLMConfig, ModelLoadingConfig,
                                   build_openai_app)
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ragged_paged_attention as ra
    from ray_tpu_torch.serve.deployment import Deployment

    kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ, ra.KERNEL]
    zero(kernels)

    def emit(stage: str, rec: dict) -> None:
        print(JOB_LINE + json.dumps({"stage": stage, **rec}), flush=True)

    rt.init()  # the session the supervisor names
    serve.start(http_port=0)
    _, port = serve.http_address()
    app = build_openai_app(LLMConfig(
        model_loading_config=ModelLoadingConfig(model_id="8b"),
        model_family="llama", engine_kwargs=http_engine_kwargs(),
        deployment_config={"ray_actor_options": {"num_gpus": 1}}))
    dep = app.deployment
    app.deployment = Deployment(probe_server(dep.func_or_class, prepare),
                                dep.name, dep.config)
    full = f"llm_{dep.name}"
    t_run = time.time()
    handle = serve.run(app, name="llm", route_prefix="/llm")
    deadline = time.monotonic() + JOB_WAIT_S
    while set(serve.status().get(full, {}).get(
            "replica_health", {}).values()) != {"healthy"}:
        if time.monotonic() > deadline:
            raise SystemExit(f"{full} not healthy: {serve.status()}")
        time.sleep(0.05)
    ready_s = time.time() - t_run
    probe = handle.probe_state.remote(True).result(timeout_s=120)
    fps = handle.probe_fingerprints.remote().result(timeout_s=120)
    path = "/llm/v1/completions"
    seq = [http_post(port, path, {"prompt": text,
                                  "max_tokens": HTTP_MAX_TOKENS,
                                  "temperature": 0.0})
           for text in http_prompts()]
    served = handle.probe_state.remote().result(timeout_s=120)
    emit("served", {
        "deployment": full, "http_port": port,
        "ids": [r["ids"] for r in served["records"]],
        "statuses": [s for _, s, _ in seq],
        "texts": [b.get("choices", [{}])[0].get("text") for _, _, b in seq],
        "latency_s": [s for s, _, _ in seq], "launches": served["launches"],
        "stats": served["stats"], "n_layers": served["n_layers"],
        "fingerprints": fps, "visible": probe["visible"],
        "replica_pid": probe["pid"], "driver_pid": os.getpid(),
        "job_start_to_healthy_s": time.time() - t0,
        "serve_run_to_ready_s": ready_s})
    deadline = time.monotonic() + JOB_WAIT_S
    while not os.path.exists(args.release):
        if time.monotonic() > deadline:
            raise SystemExit("phase 21's job was never released")
        time.sleep(0.2)
    final = handle.probe_state.remote().result(timeout_s=120)
    import torch

    emit("final", {"launches": final["launches"], "stats": final["stats"],
                   "records": len(final["records"]),
                   "driver_launches": counts(kernels),
                   "driver_cuda_initialized": torch.cuda.is_initialized(),
                   "driver_visible": os.environ.get("CUDA_VISIBLE_DEVICES")})
    serve.delete("llm")
    serve.shutdown()
    rt.shutdown()
    return 0


def cli_run(env: dict, *argv, timeout: float = CLI_TIMEOUT_S,
            check: bool = True) -> tuple[float, str]:
    """(seconds, stdout) of one call of the port's CLI."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli",
                          *argv], capture_output=True, text=True, env=env,
                         timeout=timeout)
    if check and res.returncode != 0:
        fail(f"21: `cli {' '.join(argv)}` exited {res.returncode}: "
             f"{res.stderr[-1500:]}")
    return time.perf_counter() - t0, res.stdout


def http_get(url: str, timeout: float = 120) -> tuple[float, int, bytes]:
    """(seconds, status, body) of one GET."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return time.perf_counter() - t0, r.status, r.read()
    except urllib.error.HTTPError as e:
        return time.perf_counter() - t0, e.code, e.read()


def job_lines(text: str) -> dict:
    """The 21b job's JSON lines in its log, by stage."""
    return {rec["stage"]: rec for rec in (
        json.loads(line[len(JOB_LINE):]) for line in text.splitlines()
        if line.startswith(JOB_LINE))}


def repo_json() -> dict:
    """Every JSON file at the checkout's root, by content hash (21e: no
    run of the port writes one)."""
    import hashlib

    out = {}
    for name in sorted(os.listdir(HERE)):
        if name.endswith(".json"):
            with open(os.path.join(HERE, name), "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def live_pids(pids) -> list:
    """The pids that are still running (not zombies)."""
    out = []
    for p in pids:
        try:
            with open(f"/proc/{p}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    out.append(p)
        except OSError:
            pass
    return out


def head_lines(proc, want: str, timeout_s: float) -> dict:
    """`start --head`'s `key: value` lines up to the one named `want`."""
    import queue
    import threading

    q: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            q.put(line)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()
    lines, deadline = {}, time.monotonic() + timeout_s
    while want not in lines:
        try:
            line = q.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            fail(f"21a: the head printed no {want!r} line in {timeout_s} s")
        if line is None:
            fail(f"21a: the head exited ({proc.wait()}) before {want!r}")
        key, _, val = line.strip().partition(":")
        lines[key.strip()] = val.strip()
    return lines


def job_phase(torch, kernels, card: str, expected: list[dict], fps10: dict,
              prepare: str | None = None, bench_env: dict | None = None
              ) -> dict:
    """Phase 21: the ops plane on the card, every process started the way
    a user starts it, in a fresh TMPDIR of its own. 21a the head through
    the CLI, 21b Llama-3-8B from a submitted job, 21c the dashboard's
    endpoints, 21d stopping a job and shutting down, 21e the
    microbenchmarks."""
    import glob
    import shlex
    import signal
    import tempfile
    import threading

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phase21_")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RAY_TPU_TORCH_ADDRESS", "RAY_TPU_TORCH_SESSION",
                        "RAY_TPU_TORCH_TEMP_ROOT")}
    env.update(TMPDIR=root, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    repo0 = repo_json()
    zero(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    out: dict = {"root": root}
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "start",
         "--head", "--num-cpus", "8", "--num-gpus", "1", "--dashboard",
         "--dashboard-port", "0"], stdout=subprocess.PIPE,
        stderr=open(os.path.join(root, "head.err"), "w"), text=True,
        env=env, start_new_session=True)
    sid = None
    pids: list = []
    try:
        # 21a: the head, its address and its dashboard from its own output
        t0 = time.perf_counter()
        lines = head_lines(head, "dashboard", 120)
        sd, url = lines["session dir"], lines["dashboard"]
        sid = os.path.basename(sd)[len("session_"):]
        a = out["21a"] = {"head_start_s": time.perf_counter() - t0,
                          "address": lines["address"], "dashboard": url}
        s, txt = cli_run(env, "--session", sd, "status", "--json")
        total = json.loads(txt)["total_resources"]
        _, human = cli_run(env, "--session", sd, "status")
        _, nodes = cli_run(env, "--session", sd, "list", "nodes")
        node_gpus = [n["total"].get("GPU") for n in json.loads(nodes)]
        if total.get("GPU") != 1.0 or node_gpus != [1.0] or \
                "GPU" not in human:
            fail(f"21a: the head does not show GPU: 1 (status {total}, "
                 f"nodes {node_gpus})")
        a["cli_status_s"] = s

        # 21b: Llama-3-8B from a job submitted through the CLI
        script = os.path.join(root, "job21.py")
        with open(script, "w") as f:
            f.write(f"import sys\nsys.path.insert(0, {HERE!r})\n"
                    "import chip_smoke\n"
                    "sys.exit(chip_smoke.job_main(sys.argv[1:]))\n")
        release = os.path.join(root, "release21")
        entry = [sys.executable, script, "--release", release]
        if prepare:
            entry += ["--prepare", prepare]
        t0 = time.perf_counter()
        _, txt = cli_run(env, "--session", sd, "submit", "--no-wait",
                         *map(shlex.quote, entry))
        job = txt.split()[-1]
        log = os.path.join(sd, "logs", f"job-{job}.log")
        deadline = time.monotonic() + JOB_WAIT_S
        served = None
        while served is None:
            text = open(log).read() if os.path.exists(log) else ""
            served = job_lines(text).get("served")
            if served is None:
                _, st = cli_run(env, "--session", sd, "job", "status", job)
                if st.strip() in ("FAILED", "STOPPED", "SUCCEEDED") or \
                        time.monotonic() > deadline:
                    fail(f"21b: job {job} is {st.strip()} before serving: "
                         f"{text[-3000:]}")
                time.sleep(1.0)
        b = out["21b"] = {"job": job,
                          "submit_to_served_s": time.perf_counter() - t0,
                          **{k: served[k] for k in (
                              "job_start_to_healthy_s",
                              "serve_run_to_ready_s", "latency_s",
                              "visible", "n_layers")}}
        if served["statuses"] != [200] * len(expected):
            fail(f"21b: HTTP statuses {served['statuses']}")
        got = served["ids"]
        want = [w["ids"] for w in expected]
        if got != want:
            diff = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
            fail(f"21b: the job's replica's token ids differ from in-process "
                 f"serving in requests {diff} (of {len(got)}, {len(want)})")
        if served["texts"] != [w["text"] for w in expected]:
            fail("21b: the job's texts differ from in-process serving")
        if served["fingerprints"] != fps10:
            fail("21b: the job's replica's weights differ from phase 10's")
        if served["visible"] in (None, ""):
            fail(f"21b: the replica sees CUDA_VISIBLE_DEVICES="
                 f"{served['visible']!r}")
        if served["n_layers"] != 32:
            fail(f"21b: the replica's model has {served['n_layers']} layers")

        # 21c: the dashboard, while the app is up
        c = out["21c"] = {"answer_s": {}}

        def get(path):
            s, status, body = http_get(url + path)
            c["answer_s"].setdefault(path.split("?")[0], s)
            if status != 200:
                fail(f"21c: {path} answered {status}: {body[:300]!r}")
            return body

        def get_json(path):
            return json.loads(get(path))

        jobs = get_json("/api/jobs")
        mine = [j for j in jobs if j.get("job_id") == job]
        if not mine or mine[0]["status"] != "RUNNING":
            fail(f"21c: /api/jobs has {mine} for job {job}")
        dep = get_json("/api/serve")["deployments"].get(
            served["deployment"], {})
        reps = dep.get("replicas", {})
        if len(reps) != 1 or {r["health"] for r in reps.values()} != \
                {"healthy"}:
            fail(f"21c: /api/serve shows {dep}")
        replica_aid = next(iter(reps.values()))["actor_id"]
        path = "/llm/v1/completions"
        rows, deadline = [], time.monotonic() + 30
        while len(rows) < len(expected) and time.monotonic() < deadline:
            rows = [r for r in get_json("/api/requests")
                    if r.get("path") == path]
            time.sleep(0.5)
        if len(rows) != len(expected) or any(
                str(r.get("status")) != "200" for r in rows):
            fail(f"21c: /api/requests has {len(rows)} rows for {path}: "
                 f"{rows[:2]}")
        c["request_ms"] = [1e3 * (r.get("duration_s") or 0) for r in rows]
        steps = served["stats"]["decode_steps"]
        hist, deadline = 0, time.monotonic() + 30
        while hist < steps and time.monotonic() < deadline:
            hist = sum(float(line.rsplit(" ", 1)[1]) for line in
                       get("/metrics").decode().splitlines()
                       if line.startswith(
                           "ray_tpu_llm_decode_step_seconds_count"))
            if hist < steps:
                time.sleep(1.0)
        if hist < steps:
            fail(f"21c: /metrics counts {hist} decode steps, the replica "
                 f"{steps}")
        c["decode_step_hist_count"] = hist
        wid = next((w["wid"] for w in get_json("/api/workers")
                    if w.get("actor_id") == replica_aid and not w["dead"]),
                   None)
        if wid is None:
            fail(f"21c: /api/workers has no live worker of {replica_aid}")
        wave: list = [None] * len(expected)

        def call(i):
            wave[i] = http_post(served["http_port"], path, {
                "prompt": http_prompts()[i], "max_tokens": HTTP_MAX_TOKENS,
                "temperature": 0.0})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(wave))]
        for t in threads:
            t.start()
        time.sleep(0.5)
        prof = get_json(f"/api/profile?wid={wid}&duration={PROFILE_S}&hz=50")
        for t in threads:
            t.join(timeout=600)
        if any(r is None or r[1] != 200 for r in wave):
            fail(f"21c: the wave's statuses {[r and r[1] for r in wave]}")
        if not prof.get("profile"):
            fail(f"21c: an empty profile of the replica's worker: {prof}")
        c["profile_lines"] = len(prof["profile"].splitlines())
        c["wave_latency_s"] = [r[0] for r in wave]
        tl = get_json("/api/timeline")
        if not isinstance(tl.get("traceEvents"), list):
            fail("21c: /api/timeline is no chrome trace")
        for verb in (("events",), ("trace", "list"), ("summary",)):
            s, txt = cli_run(env, "--session", sd, *verb)
            if not txt.strip():
                fail(f"21c: `cli {' '.join(verb)}` printed nothing")
            c["answer_s"]["cli " + " ".join(verb)] = s

        # 21d: a blocking job stopped through the CLI, then the first job
        # released: it deletes its app and ends
        d = out["21d"] = {}
        code = "import os, time; print('PID', os.getpid(), flush=True); " \
               "time.sleep(600)"
        _, txt = cli_run(env, "--session", sd, "submit", "--no-wait",
                         sys.executable, "-c", shlex.quote(code))
        blocker = txt.split()[-1]
        blog = os.path.join(sd, "logs", f"job-{blocker}.log")
        pid, deadline = None, time.monotonic() + 60
        while pid is None and time.monotonic() < deadline:
            text = open(blog).read() if os.path.exists(blog) else ""
            pid = next((int(ln.split()[1]) for ln in text.splitlines()
                        if ln.startswith("PID ")), None)
            time.sleep(0.2)
        _, st = cli_run(env, "--session", sd, "job", "status", blocker)
        if pid is None or st.strip() != "RUNNING":
            fail(f"21d: the blocking job is {st.strip()}, pid {pid}")
        t0 = time.perf_counter()
        cli_run(env, "--session", sd, "job", "stop", blocker)
        deadline = time.monotonic() + 60
        while st.strip() != "STOPPED" and time.monotonic() < deadline:
            _, st = cli_run(env, "--session", sd, "job", "status", blocker)
        d["stop_to_STOPPED_s"] = time.perf_counter() - t0
        if st.strip() != "STOPPED":
            fail(f"21d: the stopped job is {st.strip()}")
        deadline = time.monotonic() + 15
        while live_pids([pid]) and time.monotonic() < deadline:
            time.sleep(0.1)
        try:
            os.killpg(pid, 0)
            fail(f"21d: the stopped job's process group {pid} is alive")
        except ProcessLookupError:
            pass
        _, txt = cli_run(env, "--session", sd, "list", "workers")
        pids = [w["pid"] for w in json.loads(txt)
                if not w["dead"] and w["kind"] != "driver"]
        with open(release, "w") as f:
            f.write("go")
        deadline = time.monotonic() + 300
        st = ""
        while st.strip() not in ("SUCCEEDED", "FAILED", "STOPPED"):
            if time.monotonic() > deadline:
                fail(f"21d: job {job} is still {st.strip()}")
            time.sleep(0.5)
            _, st = cli_run(env, "--session", sd, "job", "status", job)
        _, logs = cli_run(env, "--session", sd, "job", "logs", job)
        final = job_lines(logs).get("final")
        if st.strip() != "SUCCEEDED" or final is None or \
                "served" not in job_lines(logs):
            fail(f"21d: job {job} is {st.strip()}; `job logs` lacks its "
                 f"JSON lines: {logs[-3000:]}")
        st_f, launches = final["stats"], final["launches"]
        n_layers = served["n_layers"]
        want_l = {"flash_attention_fwd_bf16": n_layers * st_f["prefills"],
                  "ragged_paged_attention_bf16":
                      n_layers * st_f["decode_steps"]}
        for sym, n in launches.items():
            if n != want_l.get(sym, 0):
                fail(f"21d: {sym} launched {n} times in the replica, "
                     f"expected {want_l.get(sym, 0)} ({st_f['prefills']} "
                     f"prefills, {st_f['decode_steps']} decode steps)")
        if any(final["driver_launches"].values()) or \
                final["driver_cuda_initialized"]:
            fail(f"21d: the job's driver launched {final['driver_launches']}"
                 f" (CUDA initialized: {final['driver_cuda_initialized']})")
        mine = counts(kernels)
        if any(mine.values()):
            fail(f"21d: chip_smoke's process launched {mine}")
        out["launches"] = launches
        d.update(prefills=st_f["prefills"], decode_steps=st_f["decode_steps"],
                 driver_visible=final["driver_visible"],
                 replica_prefill_ms_mean=1e3 * st_f["prefill_seconds"]
                 / st_f["prefills"],
                 replica_decode_step_ms_mean=1e3 * st_f["decode_seconds"]
                 / st_f["decode_steps"])
        gc.collect()
        torch.cuda.empty_cache()
        deadline = time.monotonic() + 60
        free = torch.cuda.mem_get_info()[0]
        while free0 - free > JOB_MEM_SLACK and time.monotonic() < deadline:
            time.sleep(0.5)
            free = torch.cuda.mem_get_info()[0]
        d["free_before"], d["free_after_delete"] = free0, free
        if free0 - free > JOB_MEM_SLACK:
            fail(f"21d: the card has {(free0 - free) / 2**30:.3f} GiB less "
                 f"free memory after the app was deleted")
    finally:
        if head.poll() is None:
            head.send_signal(signal.SIGINT)
        try:
            rc = head.wait(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(head.pid, signal.SIGKILL)
            rc = head.wait()
    deadline = time.monotonic() + 30
    while live_pids(pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = glob.glob(f"/dev/shm/rtpt_{sid}*") if sid else []
    if rc != 0 or left or live_pids(pids):
        fail(f"21d: the head exited {rc}; segments {sorted(left)} and "
             f"processes {live_pids(pids)} of the session are left")

    # 21e: the microbenchmarks, their artifacts under the phase's temp root
    e = out["21e"] = {}
    benv = dict(env, **(bench_env or {}))
    arts = os.path.join(root, "ray_tpu_torch", "artifacts")
    for name, cmd, art in (
            ("microbenchmark", ["-m", "ray_tpu_torch.scripts.cli",
                                "microbenchmark", "--min-seconds",
                                str(MICROBENCH_MIN_S)], "MICROBENCH.json"),
            ("llm_bench", ["-m", "ray_tpu_torch.scripts.llm_bench"],
             "LLM_MICROBENCH.json"),
            ("serve_bench", ["-m", "ray_tpu_torch.scripts.serve_bench"],
             "SERVE_BENCH.json")):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, *cmd], capture_output=True,
                             text=True, env=benv, timeout=600)
        if res.returncode != 0:
            fail(f"21e: {name} exited {res.returncode}: {res.stderr[-2000:]}")
        with open(os.path.join(arts, art)) as f:
            e[name] = json.load(f)
        e[name]["s"] = time.perf_counter() - t0
        for r in e[name]["results"]:
            print(f"21e {name} on {card}: {json.dumps(r)}", flush=True)
    lb = e["llm_bench"]
    out["llm_bench_launches"] = lb["kernel_launches"]
    lbl = lb["kernel_launches"]
    if not (lbl["flash_attention_fwd_bf16"] > 0
            and lbl["ragged_paged_attention_bf16"] > 0
            and lbl["flash_attention_bwd_dkv_bf16"] == 0
            and lbl["flash_attention_bwd_dq_bf16"] == 0):
        fail(f"21e: llm_bench launched {lbl}: both serving kernels must "
             f"run, no backward one")
    if repo_json() != repo0:
        fail("21e: a run of the port wrote a JSON file into the checkout")
    rec = {r["name"]: r["value"] for r in lb["results"]}
    agg = next(v for k, v in rec.items() if k.startswith("aggregate"))
    out["phase_s"] = time.perf_counter() - t_phase
    c = out["21c"]["answer_s"]
    print(f"ops plane on {card}: head {out['21a']['head_start_s']:.3f} s, "
          f"job submit to 8 served {out['21b']['submit_to_served_s']:.3f} s "
          f"(serve.run to ready {out['21b']['serve_run_to_ready_s']:.3f} s), "
          f"job stop {out['21d']['stop_to_STOPPED_s']:.3f} s, dashboard "
          + ", ".join(f"{k} {1e3 * v:.3f} ms" for k, v in c.items())
          + f"; llm_bench ({lb['device']}, d_model "
          f"{lb['config']['d_model']}, {lb['config']['layers']} layers): "
          f"TTFT p50 {rec['ttft_ms_p50']} ms, single stream "
          f"{rec['decode_tokens_per_s_single']} tokens/s, aggregate {agg} "
          f"tokens/s at {lb['config']['concurrency']} concurrent; phase 21 "
          f"took {out['phase_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------- phase 22

RL_SESSION = {"num_cpus": 16, "num_workers": 2, "max_workers": 8}
PPO_ITERS = 12                 # 22a: tests/test_rllib.py's PPO bar
PPO_GAIN = 15.0                # 22a: last > first + 15
DQN_MAX_ITERS = 40             # 22b: tests/test_rllib_dqn.py's DQN bar
DQN_BEST = 60.0                # 22b: best mean return >= 60
# 22a: one PPO update from the same params, Adam state and 256-row
# minibatch on the card and on the CPU, f32 with TF32 off: the worst leaf's
# max |card - cpu| over its max |cpu| within this
RL_PARITY_RTOL = 1e-5
RL_CHECK_OBS = 1024            # 22c: seeded observations for greedy actions
CPP_WAIT_S = 60.0              # 22d: the C++ worker's registration


def ppo_config(rt_rllib):
    """tests/test_rllib.py's PPO config; the learner where None puts it."""
    return (rt_rllib.PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
            .training(lr=1e-3, minibatch_size=256, num_epochs=4)
            .debugging(seed=SEED))


def runners_ready_s(rt, runners, t0: float) -> list[float]:
    """Seconds from `t0` until each runner answers a ping, in runner order."""
    refs = [r.ping.remote() for r in runners]
    ready = {}
    pending = list(refs)
    while pending:
        done, pending = rt.wait(pending, num_returns=1, timeout=300)
        if not done:
            fail("22: env runners not ready after 300 s")
        for ref in done:
            rt.get(ref)
            ready[refs.index(ref)] = time.perf_counter() - t0
    return [ready[i] for i in range(len(refs))]


class _Timed:
    """Wraps a callable; sums its host seconds per iteration."""

    def __init__(self, fn):
        self.fn, self.s = fn, 0.0

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            self.s += time.perf_counter() - t0


class _Evented:
    """Wraps an update function: a CUDA event pair around each call, read
    after the iteration (the mean update's device-side span)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.pairs = torch, fn, []

    def __call__(self, *a, **kw):
        ev = self.torch.cuda.Event
        start, end = ev(enable_timing=True), ev(enable_timing=True)
        start.record()
        out = self.fn(*a, **kw)
        end.record()
        self.pairs.append((start, end))
        return out

    def ms(self) -> list[float]:
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.pairs]


def tree_rel_err(torch, a: dict, b: dict) -> tuple[float, float]:
    """(worst leaf's max|a-b| / max|b|, worst max|a-b|) of two param trees
    (b the reference)."""
    from ray_tpu_torch.rllib.learner import leaves

    rel = absmax = 0.0
    for x, y in zip(leaves(a), leaves(b)):
        d = (x.detach().cpu() - y.detach().cpu()).abs().max().item()
        rel = max(rel, d / max(y.detach().abs().max().item(), 1e-30))
        absmax = max(absmax, d)
    return rel, absmax


def ppo_parity(torch, algo) -> dict:
    """One PPO update from the trained learner's params and Adam state on a
    fresh 256-row minibatch of its runners' data, on the card and on the
    CPU."""
    import copy

    from ray_tpu_torch.rllib import learner as learner_mod
    from ray_tpu_torch.rllib.algorithms.ppo import _train_batch

    cfg = algo.config
    samples = algo.runner_group.sample(algo.learner.get_weights_blob(),
                                       cfg.rollout_fragment_length)
    batch = _train_batch(samples, torch.device("cpu"), cfg.gamma, cfg.lam)
    mb = {k: v[:cfg.minibatch_size] for k, v in batch.items()}
    out = {}
    learners = {}
    obs_dim, n_act = algo.learner.params["layers"]["0"]["w"].shape[0], \
        algo.learner.params["pi"]["w"].shape[1]
    # a deep copy: load_state_dict keeps a state tensor that is already on
    # the param's device, and the first update would move it for the second
    state = copy.deepcopy(algo.learner.optimizer.state_dict())
    for dev in ("cuda", "cpu"):
        lrn = learner_mod.Learner(obs_dim, n_act, lr=cfg.lr,
                                  hidden=cfg.model_hidden,
                                  clip=cfg.clip_param,
                                  vf_coef=cfg.vf_loss_coeff,
                                  ent_coef=cfg.entropy_coeff, device=dev)
        with torch.no_grad():
            for dst, src in zip(learner_mod.leaves(lrn.params),
                                learner_mod.leaves(algo.learner.params)):
                dst.copy_(src)
        lrn.optimizer.load_state_dict(copy.deepcopy(state))
        out[f"{dev}_metrics"] = learner_mod.floats(
            lrn._update(lrn.params, learner_mod.batch_to(mb, lrn.device)))
        learners[dev] = lrn
    rel, absmax = tree_rel_err(torch, learners["cuda"].params,
                               learners["cpu"].params)
    moved, _ = tree_rel_err(torch, learners["cpu"].params,
                            algo.learner.params)
    out.update(rows=int(mb["obs"].shape[0]), max_rel_err=rel,
               max_abs_err=absmax, step_rel_change=moved,
               rtol=RL_PARITY_RTOL)
    if not moved > 0:
        fail("22a: the parity update moved no param")
    if not rel <= RL_PARITY_RTOL:
        fail(f"22a: one PPO update on the card and on the CPU differ by "
             f"{rel:.3g} relative (> {RL_PARITY_RTOL}; max abs {absmax:.3g})")
    return out


def ppo_22a(torch, rt, kernels) -> tuple[dict, object]:
    """PPO learns CartPole with its learner on the card (the default
    device), the runners CPU actors; returns the trained algorithm for
    22c."""
    from ray_tpu_torch import rllib

    zero(kernels)
    t0 = time.perf_counter()
    algo = ppo_config(rllib).build()
    built_s = time.perf_counter() - t0
    out = {"build_s": built_s,
           "runner_ready_s": runners_ready_s(
               rt, algo.runner_group.runners, t0)}
    dev = {t.device.type for t in rllib.learner.leaves(algo.learner.params)}
    if dev != {"cuda"}:
        fail(f"22a: the learner's params are on {dev}, not the card")
    sample = algo.runner_group.sample = _Timed(algo.runner_group.sample)
    algo.learner._update = upd = _Evented(torch, algo.learner._update)
    iters, first, last = [], None, None
    for i in range(PPO_ITERS):
        sample.s = 0.0
        t1 = time.perf_counter()
        res = algo.train()
        torch.cuda.synchronize()
        s = time.perf_counter() - t1
        ret = res["env_runners"]["episode_return_mean"]
        if ret == ret:
            first = ret if first is None else first
            last = ret
        iters.append({"s": s, "sample_s": sample.s, "learn_s": s - sample.s,
                      "return_mean": ret,
                      "total_loss": res["learners"].get("total_loss")})
        print(f"22a iteration {i}: {s:.3f} s (sample {sample.s:.3f}, learn "
              f"{s - sample.s:.3f}), return mean {ret:.2f}", flush=True)
    update_ms = upd.ms()
    algo.runner_group.sample = sample.fn
    algo.learner._update = upd.fn
    loss = iters[-1]["total_loss"]
    out.update(iterations=iters, first=first, last=last,
               updates=len(update_ms),
               update_ms_mean=sum(update_ms) / len(update_ms),
               update_ms_median=sorted(update_ms)[len(update_ms) // 2],
               update_ms_min=min(update_ms), update_ms_max=max(update_ms),
               launches=counts(kernels))
    if first is None or not last > first + PPO_GAIN:
        fail(f"22a: PPO did not learn on the card: {first} -> {last}")
    if not (loss is not None and loss == loss and abs(loss) != float("inf")):
        fail(f"22a: total_loss is not finite: {loss}")
    out["parity"] = ppo_parity(torch, algo)
    return out, algo


def dqn_22b(torch, rt, kernels) -> dict:
    """DQN learns CartPole (tests/test_rllib_dqn.py's config, at most 40
    iterations) with its online and target params on the card."""
    from ray_tpu_torch import rllib

    zero(kernels)
    t0 = time.perf_counter()
    algo = (rllib.DQNConfig().environment(env="CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8)
            .training(lr=1e-3, gamma=0.99, buffer_size=20_000,
                      train_batch_size=64, target_update_freq=200,
                      num_updates_per_step=48, learning_starts=400,
                      epsilon_decay_steps=4_000)
            .debugging(seed=SEED).build())
    try:
        out = {"build_s": time.perf_counter() - t0,
               "runner_ready_s": runners_ready_s(
                   rt, algo.runner_group.runners, t0)}
        dev = {t.device.type for t in
               rllib.learner.leaves(algo.params)
               + rllib.learner.leaves(algo.target_params)}
        if dev != {"cuda"}:
            fail(f"22b: DQN's params are on {dev}, not the card")
        sample = algo.runner_group.sample_epsilon_greedy = _Timed(
            algo.runner_group.sample_epsilon_greedy)
        algo._update = upd = _Evented(torch, algo._update)
        best, reached, learn_s = 0.0, None, 0.0
        for i in range(DQN_MAX_ITERS):
            sample.s = 0.0
            t1 = time.perf_counter()
            res = algo.train()
            torch.cuda.synchronize()
            learn_s += time.perf_counter() - t1 - sample.s
            mean = res["env_runners"]["episode_return_mean"]
            if mean == mean:
                best = max(best, mean)
            if best >= DQN_BEST:
                reached = i + 1
                break
        update_ms = upd.ms()
        n = res["learners"].get("num_updates", 0)
        out.update(best=best, iterations_to_threshold=reached,
                   num_updates=n, learn_s=learn_s,
                   updates_per_s=n / learn_s if learn_s > 0 else None,
                   update_ms_mean=(sum(update_ms) / len(update_ms)
                                   if update_ms else None),
                   update_ms_median=(sorted(update_ms)[len(update_ms) // 2]
                                     if update_ms else None),
                   launches=counts(kernels))
        if not best >= DQN_BEST:
            fail(f"22b: DQN did not reach {DQN_BEST} in {DQN_MAX_ITERS} "
                 f"iterations (best {best})")
        if not n > 0:
            fail("22b: DQN made no update")
        return out
    finally:
        algo.stop()


def checkpoint_22c(torch, algo, root: str) -> dict:
    """22a's trained PPO saved, restored into a fresh PPO on the card;
    equal params and equal greedy actions on seeded observations."""
    import numpy as np

    from ray_tpu_torch import rllib

    t0 = time.perf_counter()
    path = algo.save(os.path.join(root, "ppo_ckpt"))
    save_s = time.perf_counter() - t0
    fresh = ppo_config(rllib).env_runners(num_env_runners=0).build()
    try:
        t0 = time.perf_counter()
        fresh.restore(path)
        restore_s = time.perf_counter() - t0
        rel, _ = tree_rel_err(torch, fresh.learner.params,
                              algo.learner.params)
        obs = np.random.default_rng(SEED).normal(
            size=(RL_CHECK_OBS, 4)).astype(np.float32)
        a = rllib.rl_module.forward_inference(algo.learner.params, obs)
        b = rllib.rl_module.forward_inference(fresh.learner.params, obs)
        if a.device.type != "cuda" or b.device.type != "cuda":
            fail("22c: greedy actions not computed on the card")
        equal = int((a == b).sum().item())
        if rel != 0.0 or equal != RL_CHECK_OBS:
            fail(f"22c: restored params differ ({rel}) or greedy actions "
                 f"differ on {RL_CHECK_OBS - equal} of {RL_CHECK_OBS}")
        return {"save_s": save_s, "restore_s": restore_s,
                "equal_actions": equal, "obs": RL_CHECK_OBS,
                "action_share_1": float(a.float().mean().item())}
    finally:
        fresh.stop()


def cpp_worker_22d(rt) -> dict:
    """The port's C++ worker built by g++ here and joined to the session;
    add, concat and vec_sum answered."""
    from ray_tpu_torch import cross_lang

    binary = os.path.join(cross_lang._BUILD_DIR, "cpp_worker")
    if os.path.exists(binary):
        os.remove(binary)  # build it here, from the checkout's source
    t0 = time.perf_counter()
    cross_lang.ensure_cpp_worker_binary()
    out = {"build_s": time.perf_counter() - t0}
    proc = rt.start_cpp_worker()
    try:
        t0 = time.perf_counter()
        worker = rt._private.api._get_worker()
        while not any(w.get("wid", "").startswith("cpp-")
                      and not w.get("dead") for w in worker.rpc(
                          {"type": "list_workers"})["workers"]):
            if time.perf_counter() - t0 > CPP_WAIT_S or proc.poll() is not None:
                fail(f"22d: the C++ worker did not register (exit "
                     f"{proc.poll()})")
            time.sleep(0.05)
        out["register_s"] = time.perf_counter() - t0
        calls = {}
        for name, args, want in (("add", (2, 3), 5),
                                 ("concat", ("tpu", "-", "native"),
                                  "tpu-native"),
                                 ("vec_sum", ([1, 2, 3.5],), 6.5)):
            t0 = time.perf_counter()
            got = rt.get(rt.cpp_function(name).remote(*args), timeout=60)
            calls[name] = {"ms": 1e3 * (time.perf_counter() - t0),
                           "result": got}
            if got != want:
                fail(f"22d: {name}{args} gave {got!r}, not {want!r}")
        out["calls"] = calls
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    return out


def rl_phase(torch, rt, kernels, card: str) -> dict:
    """Phase 22 in a fresh session: 22a PPO, 22b DQN, 22c the checkpoint
    round trip, 22d the C++ worker. chip_smoke's launch counts must stay
    0 (RLlib reaches no kernel of the four)."""
    import glob
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phase22_")
    out: dict = {}
    info = rt.init(**RL_SESSION)
    sid = info["session_id"]
    algo = None
    try:
        t0 = time.perf_counter()
        out["22a"], algo = ppo_22a(torch, rt, kernels)
        out["22a"]["sub_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["22c"] = checkpoint_22c(torch, algo, root)
        out["22c"]["sub_phase_s"] = time.perf_counter() - t0
        algo.stop()
        algo = None
        t0 = time.perf_counter()
        out["22b"] = dqn_22b(torch, rt, kernels)
        out["22b"]["sub_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["22d"] = cpp_worker_22d(rt)
        out["22d"]["sub_phase_s"] = time.perf_counter() - t0
    finally:
        if algo is not None:
            algo.stop()
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    for path in ("22a", "22b"):
        if any(out[path]["launches"].values()):
            fail(f"{path}: RLlib launched a kernel: {out[path]['launches']}")
    left = glob.glob(f"/dev/shm/rtpt_{sid}*")
    if left:
        fail(f"22: shm segments of the session left: {sorted(left)}")
    out["phase_s"] = time.perf_counter() - t_phase
    a, b, d = out["22a"], out["22b"], out["22d"]
    print(f"rllib on {card}: PPO {a['first']:.2f} -> {a['last']:.2f} in "
          f"{PPO_ITERS} iterations, update {a['update_ms_mean']:.3f} ms "
          f"mean, {a['update_ms_median']:.3f} median (CUDA events, "
          f"{a['updates']} updates), card vs CPU "
          f"{a['parity']['max_rel_err']:.3g} relative; runners ready "
          + ", ".join(f"{s:.3f}" for s in a["runner_ready_s"])
          + f" s; DQN best {b['best']:.2f} in "
          f"{b['iterations_to_threshold']} iterations, "
          f"{b['updates_per_s']:.1f} updates/s; checkpoint "
          f"{out['22c']['equal_actions']}/{RL_CHECK_OBS} equal actions; "
          f"C++ worker built in {d['build_s']:.3f} s; phase 22 took "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------- phase 23

RL2_SESSION = {"num_cpus": 16, "num_workers": 2, "max_workers": 10}
# 23e's tasks hold a 0.5 GPU share, which binds no card: they reach it as
# the PD pools do (the CPU runners are not hidden from it, and use none)
RL2_ENV = {"RAY_TPU_TORCH_WORKER_PLATFORM": "cuda"}
IMPALA_ITERS = 16              # 23a/23b: tests/test_rllib_impala.py's bar
IMPALA_BAR = 40.0              # max of the last 4 mean returns > 40
SAC_MAX_ITERS = 70             # 23c: tests/test_rllib_appo_sac.py's bar
SAC_BAR = -800.0               # max of the last 4 mean returns > -800
BC_ACC = 0.9                   # 23d: tests/test_rllib_dqn.py's BC bar
BC_ROWS = 2000
MARWIL_ITERS = 12              # 23d: tests/test_rllib_offline.py's bar
MARWIL_BAR = 150.0
OFFLINE_ITERS = 12             # 23e: CQL and IQL, evaluated from the 4th
OFFLINE_FIRST_EVAL = 3         # iteration (index 3) on
OFFLINE_BAR = -800.0
OFFLINE_GPU_SHARE = 0.5        # 23e: CQL and IQL each in a half-GPU task
OFFLINE_WAIT_S = 900.0
# 23d's MARWIL starts from the JAX package's seed-0 init (written by
# tests/rllib_marwil_seeds.py): from its own seed-0 init the port's run
# ends below the bar, as the reference's own runs do at most seeds
# (`python tests/rllib_marwil_seeds.py sweep 10`)
MARWIL_INIT = os.path.join(HERE, "tests", "data", "marwil_init_seed0.npz")


def rl2_cfg(rllib, name: str):
    """The reference tests' configs: IMPALA and APPO
    (tests/test_rllib_impala.py:49-68, tests/test_rllib_appo_sac.py:74-93)
    and SAC (:118-139); the learner where None puts it."""
    if name == "sac":
        return (rllib.SACConfig().environment("Pendulum-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                             rollout_fragment_length=25)
                .training(lr=1e-3, learning_starts=600,
                          num_updates_per_step=128, train_batch_size=128)
                .debugging(seed=SEED))
    cfg = (rllib.IMPALAConfig() if name == "impala" else rllib.APPOConfig())
    return (cfg.environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=48)
            .training(lr=3e-3, **({"clip_param": 0.3} if name == "appo"
                                  else {}))
            .debugging(seed=SEED))


def on_card(rllib, *trees) -> set:
    return {t.device.type for tree in trees
            for t in rllib.learner.leaves(tree)}


def update_stats(ms: list, learn_s: float) -> dict:
    return {"updates": len(ms),
            "update_ms_mean": sum(ms) / len(ms) if ms else None,
            "update_ms_median": sorted(ms)[len(ms) // 2] if ms else None,
            "update_ms_min": min(ms) if ms else None,
            "updates_per_s": len(ms) / learn_s if learn_s > 0 else None}


class Ready:
    """Each runner's seconds to ready from `t0` (runners_ready_s), read on
    a thread of its own while the phase's earlier parts run."""

    def __init__(self, rt, runners, t0: float):
        import threading

        self.out, self.error = None, None
        self.thread = threading.Thread(target=self._run,
                                       args=(rt, list(runners), t0),
                                       daemon=True)
        self.thread.start()

    def _run(self, rt, runners, t0):
        try:
            self.out = runners_ready_s(rt, runners, t0)
        except BaseException as e:  # noqa: BLE001 — re-raised by result()
            self.error = e

    def result(self, tag: str = "23") -> list[float]:
        self.thread.join(timeout=330)
        if self.error is not None:
            raise self.error
        if self.out is None:
            fail(f"{tag}: env runners not ready after 330 s")
        return self.out


def copy_learner_state(torch, src_params: dict, dst_params: dict,
                       src_opts: list, dst_opts: list) -> None:
    """Params and Adam states of one learner into another's live leaves
    (deep copies: load_state_dict keeps a state tensor already on the
    param's device, and the first update would move it for the second)."""
    import copy

    from ray_tpu_torch.rllib.learner import leaves

    with torch.no_grad():
        for d, s in zip(leaves(dst_params), leaves(src_params)):
            d.copy_(s)
    for d, s in zip(dst_opts, src_opts):
        d.load_state_dict(copy.deepcopy(s.state_dict()))


def parity_gate(where: str, torch, a: dict, b: dict, before: dict) -> dict:
    """The card's tree against the CPU's after the same step: worst leaf's
    relative error within RL_PARITY_RTOL, and the step moved something."""
    rel, absmax = tree_rel_err(torch, a, b)
    moved, _ = tree_rel_err(torch, b, before)
    if not moved > 0:
        fail(f"{where}: the parity update moved no param")
    if not rel <= RL_PARITY_RTOL:
        fail(f"{where}: one update on the card and on the CPU differ by "
             f"{rel:.3g} relative (> {RL_PARITY_RTOL}; max abs {absmax:.3g})")
    return {"max_rel_err": rel, "max_abs_err": absmax,
            "step_rel_change": moved, "rtol": RL_PARITY_RTOL}


def streamed_run(torch, rt, kernels, name: str, algo,
                 ready: Ready) -> dict:
    """23a IMPALA / 23b APPO on CartPole: 16 iterations of the built
    `algo` with the learner on the card."""
    from ray_tpu_torch import rllib

    zero(kernels)
    out = {"runner_ready_s": ready.result()}
    lrn = algo.learner
    if on_card(rllib, lrn.params, lrn.target_params) != {"cuda"}:
        fail(f"23 {name}: the learner's params are not on the card")
    upd = lrn.update = _Evented(torch, _Timed(lrn.update))
    blob = lrn.get_weights_blob = _Timed(lrn.get_weights_blob)
    rets, iters, res = [], [], {}
    for i in range(IMPALA_ITERS):
        upd.fn.s = blob.s = 0.0
        t1 = time.perf_counter()
        res = algo.train()
        s = time.perf_counter() - t1
        learn = upd.fn.s + blob.s
        r = res["env_runners"]["episode_return_mean"]
        if r == r:
            rets.append(r)
        iters.append({"s": s, "sample_s": s - learn, "learn_s": learn,
                      "return_mean": r,
                      "batches": res["learners"]["batches_consumed"]})
        print(f"23 {name} iteration {i}: {s:.3f} s (sample {s - learn:.3f}, "
              f"learn {learn:.3f}), return mean {r:.2f}", flush=True)
    ms = upd.ms()
    lrn.update, lrn.get_weights_blob = upd.fn.fn, blob.fn
    out.update(iterations=iters, returns=rets, last_result=res["learners"],
               best_last4=max(rets[-4:]) if rets else None,
               **update_stats(ms, sum(it["learn_s"] for it in iters)))
    if not rets or not max(rets[-4:]) > IMPALA_BAR:
        fail(f"23 {name}: max of the last 4 mean returns not > "
             f"{IMPALA_BAR}: {rets}")
    return out


def impala_parity(torch, algo) -> dict:
    """One V-trace update from the trained learner's params and Adam state
    on one fresh streamed batch, on the card and on the CPU."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.algorithms.dqn import snapshot
    from ray_tpu_torch.rllib.algorithms.impala import ImpalaLearner

    cfg, src = algo.config, algo.learner
    batch = rt_get(algo._streams[0])
    batch.pop("episode_returns", None)
    obs_dim, n_act = src.params["layers"]["0"]["w"].shape[0], \
        src.params["pi"]["w"].shape[1]
    lrns = {}
    for dev in ("cuda", "cpu"):
        lrn = ImpalaLearner(obs_dim, n_act, lr=cfg.lr,
                            hidden=cfg.model_hidden,
                            vf_coef=cfg.vf_loss_coeff,
                            ent_coef=cfg.entropy_coeff, gamma=cfg.gamma,
                            device=dev)
        copy_learner_state(torch, src.params, lrn.params, [src.optimizer],
                           [lrn.optimizer])
        lrn.update(batch)
        lrns[dev] = lrn
    before = snapshot(src.params)
    return {"rows": int(batch["rewards"].size), **parity_gate(
        "23a", torch, lrns["cuda"].params, lrns["cpu"].params, before),
        "on_card": sorted(on_card(rllib, lrns["cuda"].params))}


def rt_get(stream):
    import ray_tpu_torch

    return ray_tpu_torch.get(stream.next_item(timeout=120.0), timeout=120.0)


def runner_death(rt, algo) -> dict:
    """tests/test_rllib_impala.py:72-91's case on the trained IMPALA: one
    runner killed, the next two iterations consumed batches and the pool
    is back at 2 healthy runners."""
    t0 = time.perf_counter()
    rt.kill(algo._runners[0])
    r2, r3 = algo.train(), algo.train()
    out = {"s": time.perf_counter() - t0,
           "batches": [r2["learners"]["batches_consumed"],
                       r3["learners"]["batches_consumed"]],
           "healthy": r3["learners"]["num_healthy_runners"]}
    if not sum(out["batches"]) > 0 or out["healthy"] != 2:
        fail(f"23a: after a runner's death: {out}")
    return out


def impala_23a(torch, rt, kernels, algo, ready: Ready) -> dict:
    try:
        out = streamed_run(torch, rt, kernels, "impala", algo, ready)
        out["runner_death"] = runner_death(rt, algo)
        out["launches"] = counts(kernels)
        out["parity"] = impala_parity(torch, algo)
    finally:
        algo.stop()
    return out


def appo_23b(torch, rt, kernels, algo, ready: Ready) -> dict:
    import math

    from ray_tpu_torch.rllib.learner import leaves

    try:
        out = streamed_run(torch, rt, kernels, "appo", algo, ready)
        out["launches"] = counts(kernels)
        lrn = algo.learner
        shared = [i for i, (a, b) in enumerate(zip(
            leaves(lrn.target_params), leaves(lrn.params)))
            if a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr()]
        kl = out["last_result"].get("kl")
        out.update(target_shares_storage=shared, kl=kl)
        if shared:
            fail(f"23b: APPO's target leaves {shared} share the live "
                 f"params' storage")
        if kl is None or not math.isfinite(kl):
            fail(f"23b: APPO's kl is not finite: {kl}")
    finally:
        algo.stop()
    return out


def sac_parity(torch, algo) -> dict:
    """One SAC update from the trained params, target twins and Adam
    states on one replay minibatch, with fixed Gaussian draws, on the card
    and on the CPU."""
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.rllib import learner
    from ray_tpu_torch.rllib.algorithms import sac
    from ray_tpu_torch.rllib.algorithms.dqn import snapshot

    cfg = algo.config
    batch = algo.buffer.sample(cfg.train_batch_size)
    g = torch.Generator().manual_seed(SEED + 23)
    noise = {k: torch.randn((cfg.train_batch_size, algo.action_dim),
                            generator=g) for k in ("next", "pi")}
    trees = {}
    for dev in ("cuda", "cpu"):
        d = resolve_device(dev)
        params = sac.init_sac_params(torch.Generator().manual_seed(0),
                                     algo.obs_dim, algo.action_dim,
                                     cfg.model_hidden, device=dev)
        target = snapshot({"q1": params["q1"], "q2": params["q2"]})
        opts = sac.sac_optimizers(params, cfg.lr)
        copy_learner_state(torch, {**algo.params, "t": algo.target_q},
                           {**params, "t": target},
                           list(algo.optimizers.values()),
                           list(opts.values()))
        sac.make_sac_update(
            opts, gamma=cfg.gamma, tau=cfg.tau,
            action_scale=algo.action_scale,
            target_entropy=algo.target_entropy,
            autotune=cfg.autotune_alpha)(
            params, target, learner.batch_to(batch, d),
            noise={k: v.to(d) for k, v in noise.items()})
        trees[dev] = {**params, "t": target}
    before = snapshot({**algo.params, "t": algo.target_q})
    return {"rows": cfg.train_batch_size,
            **parity_gate("23c", torch, trees["cuda"], trees["cpu"], before)}


def sac_checkpoint(torch, algo, root: str) -> dict:
    """The trained SAC saved, restored into a fresh SAC on the card: equal
    params and equal compute_single_action on seeded observations."""
    import numpy as np

    from ray_tpu_torch import rllib

    t0 = time.perf_counter()
    path = algo.save(os.path.join(root, "sac_ckpt"))
    save_s = time.perf_counter() - t0
    fresh = rl2_cfg(rllib, "sac").env_runners(num_env_runners=0).build()
    t0 = time.perf_counter()
    fresh.restore(path)
    restore_s = time.perf_counter() - t0
    rel, _ = tree_rel_err(torch, fresh.params, algo.params)
    obs = np.random.default_rng(SEED).normal(
        size=(RL_CHECK_OBS, algo.obs_dim)).astype(np.float32)
    a = np.stack([algo.compute_single_action(o) for o in obs])
    b = np.stack([fresh.compute_single_action(o) for o in obs])
    equal = int((a == b).all(axis=1).sum())
    fresh.stop()
    if on_card(rllib, fresh.params, fresh.target_q) != {"cuda"}:
        fail("23c: the restored SAC is not on the card")
    if rel != 0.0 or equal != RL_CHECK_OBS:
        fail(f"23c: restored params differ ({rel}) or actions differ on "
             f"{RL_CHECK_OBS - equal} of {RL_CHECK_OBS}")
    return {"save_s": save_s, "restore_s": restore_s,
            "equal_actions": equal, "obs": RL_CHECK_OBS}


def sac_23c(torch, rt, kernels, root: str, algo, ready: Ready) -> dict:
    """SAC on Pendulum, at most 70 iterations of the built `algo`, stopping
    once the max of the last 4 mean returns clears -800; the learner on
    the card."""
    from ray_tpu_torch import rllib

    zero(kernels)
    try:
        out = {"runner_ready_s": ready.result()}
        if on_card(rllib, algo.params, algo.target_q) != {"cuda"}:
            fail("23c: SAC's params or target twins are not on the card")
        upd = algo._update = _Evented(torch, _Timed(algo._update))
        draw = algo.buffer.sample = _Timed(algo.buffer.sample)
        rets, iters, reached = [], [], None
        for i in range(SAC_MAX_ITERS):
            upd.fn.s = draw.s = 0.0
            t1 = time.perf_counter()
            res = algo.train()
            s = time.perf_counter() - t1
            learn = upd.fn.s + draw.s
            r = res["env_runners"]["episode_return_mean"]
            if r == r:
                rets.append(r)
            iters.append({"s": s, "sample_s": s - learn, "learn_s": learn,
                          "return_mean": r})
            print(f"23c SAC iteration {i}: {s:.3f} s (sample "
                  f"{s - learn:.3f}, learn {learn:.3f}), return mean "
                  f"{r:.2f}", flush=True)
            if rets and max(rets[-4:]) > SAC_BAR:
                reached = i + 1
                break
        ms = upd.ms()
        algo._update, algo.buffer.sample = upd.fn.fn, draw.fn
        out.update(iterations=iters, iterations_to_bar=reached,
                   best_last4=max(rets[-4:]) if rets else None,
                   last_result=res["learners"], launches=counts(kernels),
                   **update_stats(ms, sum(it["learn_s"] for it in iters)))
        if reached is None:
            fail(f"23c: SAC's max of the last 4 mean returns not > "
                 f"{SAC_BAR} in {SAC_MAX_ITERS} iterations: {rets[-8:]}")
        out["parity"] = sac_parity(torch, algo)
        out["checkpoint"] = sac_checkpoint(torch, algo, root)
        return out
    finally:
        algo.stop()


def cartpole_mixed_rows(steps: int = 8000, eps: float = 0.3,
                        seed: int = 0) -> list[dict]:
    """tests/test_rllib_offline.py's mixed CartPole dataset (a stabilizing
    heuristic with eps-random actions), on the port's env (bit-equal to the
    reference's)."""
    import numpy as np

    from ray_tpu_torch.rllib.env import CartPoleVecEnv

    env = CartPoleVecEnv(num_envs=1, seed=seed)
    rng = np.random.default_rng(seed)
    obs = env.reset(seed)
    rows = []
    for _ in range(steps):
        th, th_dot = obs[0, 2], obs[0, 3]
        a = int(th + 0.5 * th_dot > 0)
        if rng.random() < eps:
            a = int(rng.integers(0, 2))
        nxt, r, d, _ = env.step(np.asarray([a]))
        rows.append({"obs": obs[0].tolist(), "action": a,
                     "reward": float(r[0]), "done": bool(d[0])})
        obs = nxt
    return rows


def pendulum_rows(episodes: int = 40, noise: float = 0.3,
                  seed: int = 0) -> list[dict]:
    """tests/test_rllib_offline.py's Pendulum dataset: an energy-shaping
    swing-up controller with exploration noise."""
    import numpy as np

    from ray_tpu_torch.rllib.env import PendulumVecEnv

    env = PendulumVecEnv(num_envs=1, seed=seed)
    rng = np.random.default_rng(seed)
    obs = env.reset(seed)
    rows = []
    for _ in range(episodes * env.MAX_STEPS):
        cos_th, sin_th, th_dot = obs[0]
        th_norm = float(np.arctan2(sin_th, cos_th))
        E = 0.5 * (1.0 / 3.0) * th_dot ** 2 + 5.0 * cos_th
        if cos_th > 0.85 and abs(th_dot) < 3.0:
            u = -10.0 * th_norm - 2.0 * th_dot
        else:
            s = np.sign(th_dot) if abs(th_dot) > 0.05 else 1.0
            u = float(np.clip(2.0 * (5.0 - E), -1.5, 1.5)) * s
        u = float(np.clip(np.clip(u, -1.5, 1.5) + rng.normal() * noise,
                          -2.0, 2.0))
        nxt, r, d, _ = env.step(np.asarray([u]))
        rows.append({"obs": obs[0].tolist(), "action": [u],
                     "reward": float(r[0]), "next_obs": nxt[0].tolist(),
                     "done": False})
        obs = nxt
    return rows


def eval_discrete(algo, num_steps: int = 1200, seed: int = 123) -> float:
    import numpy as np

    from ray_tpu_torch.rllib.env import CartPoleVecEnv

    env = CartPoleVecEnv(num_envs=4, seed=seed)
    obs = env.reset(seed)
    for _ in range(num_steps // 4):
        obs, _, _, _ = env.step(algo.predict(obs))
    rets = env.drain_episode_returns()
    return float(np.mean(rets)) if rets else float(np.mean(
        env.episode_returns))


def eval_continuous(algo, episodes: int = 4, seed: int = 123) -> float:
    import numpy as np

    from ray_tpu_torch.rllib.env import PendulumVecEnv

    env = PendulumVecEnv(num_envs=episodes, seed=seed)
    obs = env.reset(seed)
    for _ in range(env.MAX_STEPS):
        acts = np.stack([algo.compute_single_action(o) for o in obs])
        obs, _, _, _ = env.step(acts[:, 0])
    return float(np.mean(env.drain_episode_returns()))


def offline_train(torch, algo, iters: int, evaluate, first_eval: int,
                  bar=None, label: str = "") -> dict:
    """`iters` iterations of an offline algorithm with its update under
    CUDA events; evaluates from iteration `first_eval` on and stops at the
    first evaluation over `bar` (None: never stops)."""
    upd = algo._update = _Evented(torch, _Timed(algo._update))
    iters_out, evals, reached, res = [], [], None, {}
    for i in range(iters):
        upd.fn.s = 0.0
        t1 = time.perf_counter()
        res = algo.train()
        torch.cuda.synchronize()
        s = time.perf_counter() - t1
        row = {"s": s, "learn_s": s}
        if i >= first_eval:
            t2 = time.perf_counter()
            row["eval_return"] = evaluate(algo)
            row["eval_s"] = time.perf_counter() - t2
            evals.append(row["eval_return"])
        iters_out.append(row)
        print(f"23 {label} iteration {i}: learn {s:.3f} s"
              + (f", eval return {row['eval_return']:.2f}"
                 if "eval_return" in row else ""), flush=True)
        if bar is not None and evals and evals[-1] > bar:
            reached = i + 1
            break
    ms = upd.ms()
    algo._update = upd.fn.fn
    return {"iterations": iters_out, "evals": evals,
            "iterations_to_bar": reached, "last_result": res["learners"],
            **update_stats(ms, sum(it["learn_s"] for it in iters_out))}


def bc_marwil_23d(torch, rt, kernels) -> dict:
    """BC from a ray_tpu_torch.data Dataset and MARWIL on the mixed
    CartPole dataset, learners on the card."""
    import numpy as np

    from ray_tpu_torch import data as rt_data
    from ray_tpu_torch import rllib
    from ray_tpu_torch.llm import checkpoint_io
    from ray_tpu_torch.rllib.algorithm import _merge

    out = {}
    zero(kernels)
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(BC_ROWS):
        obs = rng.normal(size=4).astype(np.float32)
        rows.append({"obs": obs.tolist(), "action": int(obs[0] + obs[2] > 0)})
    t0 = time.perf_counter()
    bc = (rllib.BCConfig()
          .offline(offline_data=rt_data.from_items(rows), obs_dim=4,
                   num_actions=2, train_batch_size=256)
          .training(lr=1e-2).debugging(seed=SEED).build())
    if on_card(rllib, bc.params) != {"cuda"}:
        fail("23d: BC's params are not on the card")
    upd = bc._update = _Evented(torch, _Timed(bc._update))
    acc, res, iters = 0.0, {}, []
    for _ in range(8):
        t1 = time.perf_counter()
        res = bc.train()["learners"]
        iters.append(time.perf_counter() - t1)
        acc = res["imitation_accuracy"]
        if acc >= 0.95:
            break
    test_obs = rng.normal(size=(64, 4)).astype(np.float32)
    agree = float((bc.predict(test_obs) == (
        test_obs[:, 0] + test_obs[:, 2] > 0).astype(np.int32)).mean())
    ms = upd.ms()
    out["bc"] = {"s": time.perf_counter() - t0, "iteration_s": iters,
                 "accuracy": acc, "fresh_agreement": agree,
                 "num_samples_trained": res["num_samples_trained"],
                 "launches": counts(kernels),
                 **update_stats(ms, upd.fn.s)}
    if not (acc >= BC_ACC and res["num_samples_trained"] == BC_ROWS
            and agree >= BC_ACC):
        fail(f"23d: BC accuracy {acc}, fresh agreement {agree}, "
             f"{res['num_samples_trained']} samples")
    zero(kernels)
    rows = cartpole_mixed_rows()
    runs = {}
    for init in ("reference", "own"):
        algo = (rllib.MARWILConfig()
                .offline(offline_data=rows, obs_dim=4, num_actions=2,
                         train_batch_size=256, beta=1.0)
                .training(lr=3e-3).debugging(seed=SEED).build())
        if on_card(rllib, algo.params) != {"cuda"}:
            fail("23d: MARWIL's params are not on the card")
        if init == "reference":
            _merge(algo.params, checkpoint_io.load_params(MARWIL_INIT))
        runs[init] = offline_train(torch, algo, MARWIL_ITERS,
                                   eval_discrete, 0,
                                   label=f"MARWIL ({init} init)")
        runs[init]["num_samples_trained"] = \
            runs[init]["last_result"]["num_samples_trained"]
    out["marwil"] = {**runs["reference"], "own_init": runs["own"],
                     "launches": counts(kernels)}
    final = runs["reference"]["evals"][-1]
    if not final > MARWIL_BAR or \
            runs["reference"]["num_samples_trained"] != len(rows):
        fail(f"23d: MARWIL's evaluation after {MARWIL_ITERS} iterations "
             f"{final} not > {MARWIL_BAR}")
    return out


def offline_worker(name: str, prepare=None) -> dict:
    """23e in a half-GPU task's process: CQL or IQL on the Pendulum dataset
    (tests/test_rllib_offline.py's configs), the learner on the card,
    evaluated from the 4th iteration on and stopping at the first
    evaluation over -800 within 12 iterations; the launch counts are this
    process's. The driver holds the gates."""
    import torch

    if prepare is not None:
        prepare()
    from ray_tpu_torch import rllib
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ragged_paged_attention as ra

    t0 = time.perf_counter()
    kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ, ra.KERNEL]
    zero(kernels)
    rows = pendulum_rows()
    if name == "cql":
        cfg = rllib.CQLConfig().offline(
            offline_data=rows, obs_dim=3, action_dim=1, action_scale=2.0,
            train_batch_size=256, num_updates_per_step=1000,
            cql_alpha=0.5, tau=0.01)
    else:
        cfg = rllib.IQLConfig().offline(
            offline_data=rows, obs_dim=3, action_dim=1, action_scale=2.0,
            train_batch_size=256, num_updates_per_step=1000,
            expectile=0.7, beta=10.0, tau=0.01)
    algo = cfg.training(lr=3e-3, gamma=0.95).debugging(seed=SEED).build()
    devices = sorted(on_card(rllib, algo.params, algo.target_q))
    run = offline_train(torch, algo, OFFLINE_ITERS, eval_continuous,
                        OFFLINE_FIRST_EVAL, OFFLINE_BAR, name.upper())
    key = "cql_penalty" if name == "cql" else "v_mean"
    run.update(launches=counts(kernels), devices=devices,
               visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
               worker_s=time.perf_counter() - t0,
               **{key: run["last_result"].get(key)})
    return run


def cql_iql_23e(rt, refs: dict, t_start: float) -> dict:
    """23e's gates on the two workers' runs: the learner on the card, an
    evaluation over -800 within 12 iterations, cql_penalty and v_mean
    finite."""
    import math

    out = {}
    for name, ref in refs.items():
        run = out[name] = rt.get(ref, timeout=OFFLINE_WAIT_S)
        run["done_s"] = time.perf_counter() - t_start
        key = "cql_penalty" if name == "cql" else "v_mean"
        for i, it in enumerate(run["iterations"]):
            print(f"23e {name.upper()} iteration {i}: learn {it['s']:.3f} s"
                  + (f", eval return {it['eval_return']:.2f}"
                     if "eval_return" in it else ""), flush=True)
        if run["devices"] != ["cuda"]:
            fail(f"23e: {name}'s params are on {run['devices']}")
        if run["iterations_to_bar"] is None:
            fail(f"23e: {name}'s evaluations {run['evals']} never > "
                 f"{OFFLINE_BAR} in {OFFLINE_ITERS} iterations")
        if run[key] is None or not math.isfinite(run[key]):
            fail(f"23e: {name}'s {key} is not finite: {run[key]}")
    return out


def rl2_phase(torch, rt, kernels, card: str, prepare=None) -> dict:
    """Phase 23 in a fresh session: 23e's CQL and IQL start in two
    half-GPU tasks and run beside 23a IMPALA, 23b APPO, 23c SAC and 23d BC
    and MARWIL in the driver (an update is host-bound: two more processes
    take two more of the machine's cores). chip_smoke's launch counts must
    stay 0 in the driver and in each worker (RLlib reaches no kernel of the
    four)."""
    import glob
    import shutil
    import tempfile

    from ray_tpu_torch._private.ray_config import RayConfig

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phase23_")
    out: dict = {}
    # the workers import chip_smoke's functions by name when it is not the
    # main module
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    saved = {k: os.environ.get(k) for k in RL2_ENV}
    os.environ.update(RL2_ENV)
    RayConfig.reset()
    built = {}
    try:
        sid = rt.init(**RL2_SESSION)["session_id"]
        task = rt.remote(num_gpus=OFFLINE_GPU_SHARE)(offline_worker)
        t_e = time.perf_counter()
        refs = {n: task.remote(n, prepare) for n in ("cql", "iql")}
        # every runner starts now: each algorithm's runners come up while
        # the parts before it train
        from ray_tpu_torch import rllib

        for name in ("impala", "appo", "sac"):
            t0 = time.perf_counter()
            algo = rl2_cfg(rllib, name).build()
            runners = algo.runners if name == "sac" else algo._runners
            built[name] = (algo, Ready(rt, runners, t0))
        for part, fn in (("23a", lambda: impala_23a(torch, rt, kernels,
                                                    *built["impala"])),
                         ("23b", lambda: appo_23b(torch, rt, kernels,
                                                  *built["appo"])),
                         ("23c", lambda: sac_23c(torch, rt, kernels, root,
                                                 *built["sac"])),
                         ("23d", lambda: bc_marwil_23d(torch, rt, kernels)),
                         ("23e", lambda: cql_iql_23e(rt, refs, t_e))):
            t0 = time.perf_counter()
            out[part] = fn()
            out[part]["sub_phase_s"] = time.perf_counter() - t0
            print(f"23 {part} took {out[part]['sub_phase_s']:.1f} s",
                  flush=True)
    finally:
        for algo, _ in built.values():
            algo.stop()
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        RayConfig.reset()
    paths = {"rl_impala": out["23a"]["launches"],
             "rl_appo": out["23b"]["launches"],
             "rl_sac": out["23c"]["launches"],
             "rl_bc": out["23d"]["bc"]["launches"],
             "rl_marwil": out["23d"]["marwil"]["launches"],
             "rl_cql": out["23e"]["cql"]["launches"],
             "rl_iql": out["23e"]["iql"]["launches"]}
    for path, n in paths.items():
        if any(n.values()):
            fail(f"23 {path}: RLlib launched a kernel: {n}")
    out["launches"] = paths
    left = glob.glob(f"/dev/shm/rtpt_{sid}*")
    if left:
        fail(f"23: shm segments of the session left: {sorted(left)}")
    out["phase_s"] = time.perf_counter() - t_phase
    a, b, c = out["23a"], out["23b"], out["23c"]
    d, e = out["23d"], out["23e"]

    def upd(r):
        return (f"update {r['update_ms_median']:.3f} ms median, "
                f"{r['update_ms_mean']:.3f} mean ({r['updates']} updates, "
                f"{r['updates_per_s']:.1f}/s)")

    print(f"rllib part two on {card}: IMPALA best of last 4 "
          f"{a['best_last4']:.2f}, {upd(a)}, card vs CPU "
          f"{a['parity']['max_rel_err']:.3g}, runner death healed in "
          f"{a['runner_death']['s']:.3f} s; APPO {b['best_last4']:.2f}, "
          f"{upd(b)}; SAC {c['best_last4']:.2f} in "
          f"{c['iterations_to_bar']} iterations, {upd(c)}, card vs CPU "
          f"{c['parity']['max_rel_err']:.3g}, checkpoint "
          f"{c['checkpoint']['equal_actions']}/{RL_CHECK_OBS}; BC "
          f"{d['bc']['accuracy']:.3f}, {upd(d['bc'])}; MARWIL "
          f"{d['marwil']['evals'][-1]:.1f} (own init "
          f"{d['marwil']['own_init']['evals'][-1]:.1f}), {upd(d['marwil'])};"
          f" CQL {e['cql']['evals'][-1]:.1f} in "
          f"{e['cql']['iterations_to_bar']} iterations, {upd(e['cql'])}; "
          f"IQL {e['iql']['evals'][-1]:.1f} in "
          f"{e['iql']['iterations_to_bar']} iterations, {upd(e['iql'])}; "
          f"runners ready "
          + ", ".join(f"{s:.3f}" for s in a["runner_ready_s"]
                      + b["runner_ready_s"] + c["runner_ready_s"])
          + f" s; phase 23 took {out['phase_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------- phase 24

DREAMER_ITERS = 40             # 24b: tests/test_rllib_dreamer.py's bar
DREAMER_BAR = 60.0             # max of the last 10 mean returns > 60
DREAMER_WM_BAR = 2.0           # and the last wm_loss < 2.0
# 24a: one world-model and one dream update on the card and on the CPU,
# f32 with TF32 off: every leaf's max |card - cpu| within this
DREAMER_ABS_TOL = 1e-4


def dreamer_cfg(rllib):
    """tests/test_rllib_dreamer.py:57-64's config; the learner where None
    puts it."""
    return (rllib.DreamerV3Config().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .training(learning_starts=512, num_updates_per_step=8)
            .debugging(seed=SEED))


def cartpole_windows(B: int, T: int, seed: int) -> dict:
    """B windows of T CartPole steps under uniform random actions, in the
    sequence buffer's layout [B, T, ...] (prev_actions and is_first as the
    runner keeps them)."""
    import numpy as np

    from ray_tpu_torch.rllib.env import CartPoleVecEnv

    env = CartPoleVecEnv(num_envs=B, seed=seed)
    rng = np.random.default_rng(seed)
    obs = env.reset(seed)
    prev, first = np.zeros(B, np.int64), np.ones(B, np.float32)
    cols = {k: [] for k in ("obs", "actions", "prev_actions", "rewards",
                            "dones", "is_first")}
    for _ in range(T):
        a = rng.integers(0, 2, B)
        cols["obs"].append(obs)
        cols["prev_actions"].append(prev)
        cols["is_first"].append(first)
        obs, r, d, _ = env.step(a)
        cols["actions"].append(a)
        cols["rewards"].append(r)
        cols["dones"].append(d)
        prev, first = a, d.astype(np.float32)
    return {k: np.stack(v, 1) for k, v in cols.items()}


def leaf_abs_diffs(torch, a: dict, b: dict, prefix: str = "") -> dict:
    """max |a - b| of every leaf of two trees, by path."""
    if not isinstance(a, dict):
        return {prefix: (a.detach().cpu() - b.detach().cpu()).abs()
                .max().item()}
    out = {}
    for k in sorted(a):
        out.update(leaf_abs_diffs(torch, a[k], b[k], f"{prefix}{k}/"))
    return out


def tree_to(tree, device):
    """A detached copy of a params tree on `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device, copy=True)


def dreamer_parity_24a(torch, cfg) -> dict:
    """One world-model update and one dream update from the seed-0 init on
    the card and on the CPU, with the same batch and Gumbel draws."""
    from ray_tpu_torch import _device
    from ray_tpu_torch.rllib import learner
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as dv
    from ray_tpu_torch.rllib.algorithms.dqn import snapshot

    t0 = time.perf_counter()
    B, T, H = cfg.batch_size_B, cfg.batch_length_T, cfg.horizon_H
    S, C, A = cfg.stoch_dims, cfg.stoch_classes, 2
    batch = dv.time_major(cartpole_windows(B, T, SEED), A)
    init = dv.init_dreamer_params(torch.Generator().manual_seed(SEED), 4, A,
                                  cfg, device="cpu")
    g = torch.Generator().manual_seed(SEED + 24)
    like = torch.zeros(())
    noise = {"wm": dv.gumbel(g, (T, B, S, C), like),
             "action": dv.gumbel(g, (H, T * B, A), like),
             "z": dv.gumbel(g, (H, T * B, S, C), like)}
    runs = {}
    for dev in ("cuda", "cpu"):
        d = _device.resolve_device(dev)
        params = tree_to(init, d)
        slow = snapshot(params["critic"])
        wm = {k: params[k] for k in dv.WM_KEYS}
        wm_update = dv.make_world_model_update(
            learner.make_optimizer(wm, cfg.world_lr), cfg, A)
        dream_update = dv.make_dream_update(
            learner.make_optimizer(params["actor"], cfg.actor_lr),
            learner.make_optimizer(params["critic"], cfg.critic_lr), cfg, A)
        dn = {"action": noise["action"].to(d), "z": noise["z"].to(d)}
        feats, wm_m = wm_update(wm, learner.batch_to(batch, d),
                                noise=noise["wm"].to(d))
        feats0 = feats.reshape(-1, feats.shape[-1])
        # the imagination the dream update is about to roll, sampled
        # indices and all
        dream_feats, acts = dv.imagine(params, feats0, cfg, A, noise=dn)
        ema, dm = dream_update(params, slow, torch.ones((), device=d),
                               feats0, noise=dn)
        D = cfg.deter_dim
        runs[dev] = {
            "tree": {"params": params, "slow_critic": slow, "ret_ema": ema,
                     "feats": feats},
            "indices": torch.cat([
                feats[..., D:].reshape(-1, S, C).argmax(-1).reshape(-1),
                dream_feats[..., D:].reshape(-1, S, C).argmax(-1)
                .reshape(-1), acts.reshape(-1)]).cpu(),
            "metrics": learner.floats({**wm_m, **dm})}
    diffs = leaf_abs_diffs(torch, runs["cuda"]["tree"], runs["cpu"]["tree"])
    moved = max(leaf_abs_diffs(torch, runs["cpu"]["tree"]["params"],
                               init).values())
    flipped = int((runs["cuda"]["indices"]
                   != runs["cpu"]["indices"]).sum())
    worst = max(diffs.values())
    out = {"max_abs_err": worst, "leaf_max_abs_err": diffs,
           "indices": int(runs["cpu"]["indices"].numel()),
           "indices_differing": flipped, "step_max_abs_change": moved,
           "metrics_cuda": runs["cuda"]["metrics"],
           "metrics_cpu": runs["cpu"]["metrics"], "atol": DREAMER_ABS_TOL,
           "s": time.perf_counter() - t0}
    slow = max(v for k, v in diffs.items() if k.startswith("slow_critic"))
    print(f"24a card vs CPU: max abs {worst:.3g} over {len(diffs)} leaves "
          f"(slow critic {slow:.3g}, ret_ema {diffs['ret_ema/']:.3g}, feats "
          f"{diffs['feats/']:.3g}); {flipped} of {out['indices']} sampled "
          f"indices differ", flush=True)
    if not moved > 0:
        fail("24a: the parity updates moved no param")
    if flipped or not worst <= DREAMER_ABS_TOL:
        fail(f"24a: one world-model and one dream update on the card and on "
             f"the CPU differ by {worst:.3g} (> {DREAMER_ABS_TOL}) or in "
             f"{flipped} sampled indices")
    return out


def dreamer_24b(torch, rt, kernels, algo, ready: Ready) -> dict:
    """tests/test_rllib_dreamer.py's run: 40 iterations of the built `algo`
    with the learner on the card, its bar."""
    from ray_tpu_torch import rllib

    zero(kernels)
    out = {"runner_ready_s": ready.result("24b")}
    if on_card(rllib, algo.params, algo.slow_critic) != {"cuda"} or \
            algo.ret_ema.device.type != "cuda":
        fail("24b: DreamerV3's params, slow critic or return EMA are not on "
             "the card")
    wm = algo._wm_update = _Evented(torch, _Timed(algo._wm_update))
    dr = algo._dream_update = _Evented(torch, _Timed(algo._dream_update))
    draw = algo.buffer.sample = _Timed(algo.buffer.sample)
    rets, iters, res = [], [], {}
    for i in range(DREAMER_ITERS):
        wm.fn.s = dr.fn.s = draw.s = 0.0
        t1 = time.perf_counter()
        res = algo.train()
        s = time.perf_counter() - t1
        learn = wm.fn.s + dr.fn.s + draw.s
        r = res["env_runners"]["episode_return_mean"]
        if r == r:
            rets.append(r)
        lm = res["learners"]
        iters.append({"s": s, "sample_s": s - learn, "learn_s": learn,
                      "return_mean": r, "wm_loss": lm.get("wm_loss"),
                      "env_steps": lm["env_steps"]})
        print(f"24b DreamerV3 iteration {i}: {s:.3f} s (sample "
              f"{s - learn:.3f}, learn {learn:.3f}), return mean {r:.2f}, "
              f"wm_loss {lm.get('wm_loss', float('nan')):.4f}", flush=True)
    wm_ms, dr_ms = wm.ms(), dr.ms()
    algo._wm_update, algo._dream_update = wm.fn.fn, dr.fn.fn
    algo.buffer.sample = draw.fn
    learn_s = sum(it["learn_s"] for it in iters)
    out.update(iterations=iters, returns=rets, last_result=res["learners"],
               best_last10=max(rets[-10:]) if rets else None,
               launches=counts(kernels),
               world_model=update_stats(wm_ms, learn_s),
               dream=update_stats(dr_ms, learn_s),
               sample_s=sum(it["sample_s"] for it in iters),
               learn_s=learn_s)
    wm_loss = res["learners"].get("wm_loss", float("inf"))
    if not rets or not max(rets[-10:]) > DREAMER_BAR or \
            not wm_loss < DREAMER_WM_BAR:
        fail(f"24b: DreamerV3's max of the last 10 mean returns not > "
             f"{DREAMER_BAR} or wm_loss {wm_loss} not < {DREAMER_WM_BAR}: "
             f"{rets[-10:]}")
    return out


def dreamer_phase(torch, rt, kernels, card: str) -> dict:
    """Phase 24 in a fresh session: the runners start with the phase, 24a's
    parity runs while they come up, then 24b trains. chip_smoke's launch
    counts must stay 0 (DreamerV3 reaches no kernel of the four)."""
    import glob

    t_phase = time.perf_counter()
    out: dict = {}
    algo = None
    try:
        sid = rt.init(**RL2_SESSION)["session_id"]
        from ray_tpu_torch import rllib

        t0 = time.perf_counter()
        algo = dreamer_cfg(rllib).build()
        ready = Ready(rt, algo.runners, t0)
        zero(kernels)
        out["24a"] = dreamer_parity_24a(torch, algo.config)
        out["24a"]["launches"] = counts(kernels)
        t1 = time.perf_counter()
        out["24b"] = dreamer_24b(torch, rt, kernels, algo, ready)
        out["24b"]["sub_phase_s"] = time.perf_counter() - t1
    finally:
        if algo is not None:
            algo.stop()
        rt.shutdown()
    for part in ("24a", "24b"):
        if any(out[part]["launches"].values()):
            fail(f"24 {part}: DreamerV3 launched a kernel: "
                 f"{out[part]['launches']}")
    out["launches"] = out["24b"]["launches"]
    left = glob.glob(f"/dev/shm/rtpt_{sid}*")
    if left:
        fail(f"24: shm segments of the session left: {sorted(left)}")
    out["phase_s"] = time.perf_counter() - t_phase
    a, b = out["24a"], out["24b"]

    def upd(r):
        return (f"{r['update_ms_median']:.3f} ms median, "
                f"{r['update_ms_mean']:.3f} mean ({r['updates']} updates)")

    print(f"dreamerv3 on {card}: returns "
          + ", ".join(f"{r:.1f}" for r in b["returns"])
          + f"; best of last 10 {b['best_last10']:.2f}, wm_loss "
          f"{b['last_result']['wm_loss']:.4f}; world-model update "
          f"{upd(b['world_model'])}, dream update {upd(b['dream'])}; "
          f"sample {b['sample_s']:.3f} s, learn {b['learn_s']:.3f} s; card "
          f"vs CPU {a['max_abs_err']:.3g}, {a['indices_differing']} of "
          f"{a['indices']} indices differ; runners ready "
          + ", ".join(f"{s:.3f}" for s in b["runner_ready_s"])
          + f" s; phase 24 took {out['phase_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------- phase 11

TP = 2
HOLD_PROMPT, HOLD_BUCKET = 1000, 1024


def mesh_train(torch, kernels) -> dict:
    """11a: a world of one over NCCL. Llama-3.2-1B (phase 6's config, batch
    4 x 2048) takes 3 steps through the meshed make_train_step, then 3
    through the unmeshed step from the same params and batch; both must
    agree bit for bit."""
    import datetime
    import functools
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from ray_tpu_torch import train as tr
    from ray_tpu_torch.benchmarks.train_step import LR, WEIGHT_DECAY
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.parallel import MeshSpec, collectives

    dev = torch.device("cuda")
    cfg = train_config()
    steps, batch, seq = 3, 4, 2048
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          size=(batch, seq + 1)), device=dev)

    def loss_fn(p, b):
        return transformer.loss_fn(p, b, cfg)

    factory = functools.partial(tr.adamw, learning_rate=LR,
                                weight_decay=WEIGHT_DECAY)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = MeshSpec().build()
        backend = dist.get_backend()
        step, shard_params, batch_sharding = tr.make_train_step(
            loss_fn, factory, mesh=mesh,
            logical_axes=transformer.logical_axes(cfg))
        params = shard_params(transformer.init(
            torch.Generator(device=dev).manual_seed(SEED), cfg, dev))
        state = factory(params)
        local = batch_sharding.shard(tokens)
        torch.cuda.synchronize()
        zero(kernels)  # the meshed path starts here
        collectives.calls.clear()
        meshed_losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, loss = step(params, state, local)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            meshed_losses.append(loss)
        launches = counts(kernels)
        calls = dict(collectives.calls)
        meshed = [p.detach() for p in tr.param_leaves(params)]
        del state, params
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    params = transformer.init(torch.Generator(device=dev).manual_seed(SEED),
                              cfg, dev)
    opt = tr.adamw(params, LR, weight_decay=WEIGHT_DECAY)
    plain_step = tr.make_train_step(loss_fn, opt)
    plain_losses, plain_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, _, loss = plain_step(params, opt.state, tokens)
        torch.cuda.synchronize()
        plain_ms.append(1e3 * (time.perf_counter() - t0))
        plain_losses.append(loss)
    loss_diff = max(abs(a.item() - b.item())
                    for a, b in zip(meshed_losses, plain_losses))
    param_diff = max((a.float() - b.detach().float()).abs().max().item()
                     for a, b in zip(meshed, tr.param_leaves(params)))
    del meshed, params, opt
    torch.cuda.empty_cache()
    if loss_diff != 0.0 or param_diff != 0.0:
        fail(f"meshed step (world of one) vs unmeshed: max loss diff "
             f"{loss_diff}, max param diff {param_diff}; the bound is 0")
    L = cfg.n_layers
    per_step = {k: n / steps for k, n in launches.items()}
    want = {"flash_attention_fwd_bf16": 2 * L,
            "flash_attention_bwd_dkv_bf16": L,
            "flash_attention_bwd_dq_bf16": L,
            "ragged_paged_attention_bf16": 0}
    if per_step != want:
        fail(f"meshed step launches per step {per_step}, expected phase "
             f"6's {want}")
    calls_per_step = {k: n / steps for k, n in calls.items()}
    if not calls_per_step or min(calls_per_step.values()) <= 0:
        fail(f"meshed step issued no collective: {calls}")
    return {"backend": backend, "mesh": "MeshSpec() world of one",
            "model": "llama-3.2-1b (tied, random init)", "batch": batch,
            "seq": seq, "steps": steps,
            "losses": [x.item() for x in meshed_losses],
            "max_loss_diff": loss_diff, "max_param_diff": param_diff,
            "bound": 0.0, "launches": launches,
            "launches_per_step": per_step,
            "collective_calls_per_step": calls_per_step,
            # host clock, a sync after each step; the first step also
            # creates the NCCL communicators and the AdamW state
            "meshed_step_ms": step_ms, "unmeshed_step_ms": plain_ms}


def hold_rows(torch, params, cfg, impl, forced=None):
    """Logits [3, V] (f32, on the host) of a HOLD_PROMPT-token prefill at
    bucket HOLD_BUCKET and 2 ragged paged decode steps, the decode inputs
    teacher-forced with `forced` (default: this run's own argmax). The
    pool has the head counts of `params` (a tensor-parallel rank's, under
    its mesh). Returns (rows, the tokens fed)."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import decoding, transformer
    from ray_tpu_torch.models import decoding_paged as dp

    dev = params["embed"].device
    H, Hkv = transformer.local_heads(params)
    state_cfg = dataclasses.replace(cfg, n_heads=H, n_kv_heads=Hkv,
                                    d_head=cfg.head_dim)
    P, max_len = 64, 2048
    rng = np.random.default_rng(SEED + 11)
    padded = np.zeros((1, HOLD_BUCKET), np.int64)
    padded[0, :HOLD_PROMPT] = rng.integers(0, cfg.vocab_size,
                                           size=HOLD_PROMPT)
    logits, kv = decoding.prefill(params, torch.as_tensor(padded, device=dev),
                                  HOLD_PROMPT, cfg, attn_impl=impl)
    rows, fed = [logits], []
    nxt = int(torch.argmax(logits)) if forced is None else forced[0]
    state = dp.init_paged_state(state_cfg, 8, max_len, max_len // P + 1, P,
                                dev)
    dp.insert_sequence_paged(state, 0, kv, HOLD_PROMPT, nxt,
                             np.arange(1, max_len // P + 1, dtype=np.int32),
                             cfg)
    fed.append(nxt)
    for step in range(2):
        bound = 1 << ((HOLD_PROMPT + step) // P).bit_length()
        state, lg = dp.decode_step_paged_ragged(params, state, cfg, bound,
                                                impl=impl)
        rows.append(lg[0])
        if step == 0:
            nxt = int(torch.argmax(lg[0])) if forced is None else forced[1]
            fed.append(nxt)
            decoding.commit_tokens(state, torch.full(
                (8,), nxt, dtype=torch.int32, device=dev))
    out = torch.stack([r.float() for r in rows]).cpu()
    del state, kv
    return out, fed


def tp_serve_rank(forced, lengths):
    """One rank of 11b: Llama-3-8B's tensor-parallel cut (tp = 2) from the
    seed-0 weights, the hold rows teacher-forced with `forced`, then
    LLMEngine.from_config(mesh=tp 2) serving phase 4's prompts."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import (LLMConfig, LLMEngine, ModelLoadingConfig,
                                   SamplingParams)
    from ray_tpu_torch.llm.engine import shard_params_tp
    from ray_tpu_torch.models import llama, transformer
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ragged_paged_attention as ra
    from ray_tpu_torch.parallel import MeshSpec, collectives, use_mesh

    kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ, ra.KERNEL]
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = MeshSpec(tp=TP).build()
    cfg = llama.llama_config("8b")
    full = transformer.init(torch.Generator(device=dev).manual_seed(SEED),
                            cfg, dev, dtype=cfg.dtype)
    params = shard_params_tp(full, mesh)
    del full
    torch.cuda.empty_cache()
    with use_mesh(mesh):
        rows, _ = hold_rows(torch, params, cfg, None, forced)
        # one gloo allreduce on CUDA tensors at a decode step's [8, 1, E]
        # and a bucket-1024 prefill's [1, 1024, E] (bf16), host clock
        gloo_ms = {}
        for name, shape in (("decode_8x1", (8, 1, cfg.d_model)),
                            ("prefill_1024", (1, 1024, cfg.d_model))):
            x = torch.ones(shape, dtype=cfg.dtype, device=dev)
            collectives.allreduce(x, "tp")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                collectives.allreduce(x, "tp")
            torch.cuda.synchronize()
            gloo_ms[name] = 1e3 * (time.perf_counter() - t0) / 20
    kv_heads = transformer.local_heads(params)[1]
    del params
    torch.cuda.empty_cache()
    eng = LLMEngine.from_config(LLMConfig(
        model_family="llama",
        model_loading_config=ModelLoadingConfig(model_id="8b"),
        engine_kwargs={"kv_layout": "paged", "page_size": 64, "max_slots": 8,
                       "max_len": 2048, "seed": SEED, "mesh": mesh}))
    try:
        rng = np.random.default_rng(SEED + 1)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
                   for n in lengths]
        torch.cuda.synchronize()
        zero(kernels)  # this rank's main path starts here
        t0 = time.perf_counter()
        reqs = [eng.submit(p, SamplingParams(max_tokens=32, temperature=0.0))
                for p in prompts]
        outs = [list(r) for r in reqs]
        wall = time.perf_counter() - t0
        launches = counts(kernels)
        st = eng.stats()
        pool = tuple(eng.state["kp"].shape)
    finally:
        eng.shutdown()
    return {"rows": rows.numpy(), "outs": outs, "launches": launches,
            "stats": st, "wall_s": wall, "pool": pool, "gloo_ms": gloo_ms,
            "kv_heads": kv_heads, "memory_gib":
            torch.cuda.max_memory_allocated(dev) / 2**30}


def serve_tp(torch, card: str) -> dict:
    """11b: the hold rows at tp = 1 and f32 here, then 2 ranks over gloo on
    the card (see the module docstring)."""
    import dataclasses

    from ray_tpu_torch.models import llama, transformer
    from ray_tpu_torch.parallel import launch

    dev = torch.device("cuda")
    cfg = llama.llama_config("8b")
    params = transformer.init(torch.Generator(device=dev).manual_seed(SEED),
                              cfg, dev, dtype=cfg.dtype)
    f32, forced = hold_rows(torch, params, dataclasses.replace(
        cfg, dtype=torch.float32), "reference")
    tp1, _ = hold_rows(torch, params, cfg, None, forced)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(tp_serve_rank, TP, args=(forced, SERVE_LENGTHS),
                   backend="gloo", device="cuda", timeout=600, threads=None)
    spawn_s = time.perf_counter() - t0
    label = f"{TP} ranks sharing one H100 over gloo"
    rows = []
    for what, i in (("prefill", 0), ("decode 0", 1), ("decode 1", 2)):
        for r, res in enumerate(ranks):
            row = {"step": what, "rank": r, **logit_row(
                torch, f"tp={TP} {what} rank {r}",
                torch.as_tensor(res["rows"][i]), tp1[i], f32[i])}
            hold(f"tp={TP} {what} rank {r}", row)
            rows.append(row)
    if ranks[0]["outs"] != ranks[1]["outs"]:
        fail(f"tp={TP} ranks emitted different tokens")
    n_layers = cfg.n_layers
    for r, res in enumerate(ranks):
        st, n = res["stats"], res["launches"]
        for out in res["outs"]:
            if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
                fail(f"tp rank {r}: a request gave {len(out)} tokens")
        if n["ragged_paged_attention_bf16"] != n_layers * st["decode_steps"]:
            fail(f"tp rank {r}: ragged launches {n} != {n_layers} x "
                 f"{st['decode_steps']} decode steps")
        if n["flash_attention_fwd_bf16"] != n_layers * st["prefills"]:
            fail(f"tp rank {r}: flash launches {n} != {n_layers} x "
                 f"{st['prefills']} prefills")
        if n["flash_attention_bwd_dkv_bf16"] or n["flash_attention_bwd_dq_bf16"]:
            fail(f"tp rank {r}: a backward kernel launched while serving")
        if res["pool"][3] != cfg.kv_heads // TP:
            fail(f"tp rank {r}: pool {res['pool']} is not 4 kv heads")
    st = ranks[0]["stats"]
    return {"label": label, "card": card, "model": "llama-3-8b random init bf16",
            "tp": TP, "hold": rows, "forced_tokens": forced,
            "requests": len(SERVE_LENGTHS), "prompt_lengths": SERVE_LENGTHS,
            "same_tokens_on_every_rank": True,
            "launches_by_rank": [r["launches"] for r in ranks],
            "decode_steps": st["decode_steps"], "prefills": st["prefills"],
            "prefill_ms_mean": 1e3 * st["prefill_seconds"] / st["prefills"],
            "decode_step_ms_mean": 1e3 * st["decode_seconds"]
            / st["decode_steps"],
            "wall_s": ranks[0]["wall_s"], "spawn_to_done_s": spawn_s,
            "pool_shape": ranks[0]["pool"],
            "gloo_allreduce_ms_by_rank": [r["gloo_ms"] for r in ranks],
            "max_memory_gib_by_rank": [r["memory_gib"] for r in ranks]}


def dryrun_tp(torch) -> dict:
    """11c: the dryrun twin on 4 ranks sharing the card over gloo."""
    from ray_tpu_torch.parallel import dryrun

    # gloo takes all_reduce (sum, max), all_gather and all_to_all_single
    # (even and uneven splits) on f32 and bf16 CUDA tensors, the only calls
    # parallel/ makes (its send/recv, which parallel/ never calls, take CPU
    # tensors only), so every program runs on the card
    print("dryrun: every program on CUDA tensors (gloo takes every "
          "collective parallel/ calls on them)", flush=True)
    t0 = time.perf_counter()
    res = dryrun.dryrun_multichip(4, device="cuda", backend="gloo",
                                  timeout=600)
    return {"label": "4 ranks sharing one H100 over gloo", "device": "cuda",
            "wall_s": time.perf_counter() - t0,
            "rank0": res[0]}


# phase 23 runs in a process of its own, beside the driver's phases 22, 24
# and 11; none of those gates the card's free memory (19-21 do, and are
# done by then)
LANE_WAIT_S = 900.0


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def lane_main(torch, out_path: str) -> int:
    """``--phase 23 --out <path>``: phase 23, its result to `path` as
    JSON."""
    import ray_tpu_torch

    out = rl2_phase(torch, ray_tpu_torch, loop_kernels(), card_name())
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


class Lane:
    """A phase in ``chip_smoke.py --phase``, started now and joined
    later; its output goes to a file that `join` echoes, so no
    line of it interleaves with the driver's."""

    def __init__(self, name: str):
        import tempfile

        self.name = name
        self.dir = tempfile.mkdtemp(prefix=f"chip_smoke_phase{name}_")
        self.log = open(os.path.join(self.dir, "out.log"), "wb")
        self.out = os.path.join(self.dir, "out.json")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase", name,
             "--out", self.out], cwd=HERE, stdout=self.log,
            stderr=subprocess.STDOUT, start_new_session=True)

    def join(self) -> dict:
        try:
            rc = self.proc.wait(timeout=LANE_WAIT_S)
        except subprocess.TimeoutExpired:
            rc = None
        self.log.close()
        with open(self.log.name, errors="replace") as f:
            sys.stdout.write(f.read())
        print(f"phase {self.name} in its own process: exit {rc} after "
              f"{time.perf_counter() - self.t0:.1f} s", flush=True)
        if rc != 0:
            fail(f"phase {self.name} in its own process: exit {rc}")
        with open(self.out) as f:
            return json.load(f)

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except OSError:
                pass
            self.proc.wait(timeout=30)
        if not self.log.closed:
            self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-kernels", action="store_true",
                    help="stop after building and checking the kernels")
    ap.add_argument("--phase", choices=["23"],
                    help="run this phase alone (the script starts it in a "
                    "process of its own)")
    ap.add_argument("--out", help="--phase: where its result goes (JSON)")
    args = ap.parse_args()
    t_script = time.perf_counter()

    def stamp(done: str) -> None:
        """Where the script's clock stands: the phases before 14 print no
        time of their own."""
        print(f"{done} done at {time.perf_counter() - t_script:.1f} s of "
              "script", flush=True)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repo (ray_tpu_torch/ "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.phase:
        return lane_main(torch, args.out)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ragged_paged_attention as ra

    card = card_name()
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "warning")):
                print(f"  {name}: {line.strip()}")
    ptxas = ptxas_summary(logs)
    print(json.dumps({"build_s": build_s, "built": sorted(logs),
                      "ptxas": ptxas}), flush=True)
    spilled = [r for r in ptxas if r["spill_stores"]]
    if spilled:
        fail(f"ptxas reports spill stores: {spilled}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the kernels' own tiles are 128 rows: T = 64 and 192 end in a half
    # tile, T = 2048 in whole ones; both head dims, causal and full, forward
    # and backward, untimed
    checks = [check_flash(torch, gen, T, causal, timed=False, D=D, B=2)
              for T, D, causal in EDGE_CASES]
    checks += [check_flash_bwd(torch, gen, 2, T, D, causal, timed=False)
               for T, D, causal in EDGE_CASES]
    checks += [check_flash(torch, gen, T, True, timed=True)
               for T in (64, 1024, 2048)]
    checks.append(check_flash(torch, gen, 1024, False, timed=True))
    # a coalesced prefill's shape (phase 12b: two prompts of bucket 1024)
    checks.append(check_flash(torch, gen, 1024, True, timed=True, B=2))
    checks.append(check_flash(torch, gen, 2048, True, timed=True, D=64, B=4))
    rin = ragged_inputs(torch, gen)
    checks += [check_ragged(torch, rin, nb, timed=True) for nb in (1, 16, 32)]
    B, P = rin[0].shape[0], rin[1].shape[1]
    full = torch.full((B,), 32 * P - 1, dtype=torch.int32, device="cuda")
    checks.append(check_ragged(torch, rin, 32, True, full, " all full"))
    checks.append(check_ragged(torch, rin, 32, True, torch.zeros_like(full),
                               " all at pos 0"))
    checks.append(check_ragged(torch, rin, 23, timed=False))
    del rin
    # the other compiled variants (smaller pages), checked untimed
    for Dh, P in ((64, 16), (128, 32)):
        rin = ragged_inputs(torch, gen, Dh=Dh, P=P, N=33)
        checks.append(check_ragged(torch, rin, 4, timed=False))
    # GPT-2's shapes (phase 9): MHA at head_dim 64, G = 1 in decode
    checks.append(check_flash(torch, gen, 1024, True, timed=False, D=64,
                              H=12, Hkv=12))
    rin = ragged_inputs(torch, gen, Dh=64, P=64, N=129, Hkv=12, G=1)
    checks.append(check_ragged(torch, rin, 16, False, label=" Hkv=12 G=1 "
                               "Dh=64"))
    del rin
    # a tensor-parallel rank's shapes (phase 11): Llama-3-8B at tp = 2
    checks.append(check_flash(torch, gen, 2048, True, timed=True, H=16,
                              Hkv=4))
    rin = ragged_inputs(torch, gen, Hkv=4, G=4)
    checks.append(check_ragged(torch, rin, 32, timed=True, label=" Hkv=4 G=4"))
    del rin
    # the backward at the training path's shape (Llama-3.2-1B, batch 4),
    # at head_dim 128, full attention, and a one-tile sequence
    checks += [check_flash_bwd(torch, gen, 4, 2048, 64, True, timed=True),
               check_flash_bwd(torch, gen, 1, 2048, 128, True, timed=True),
               check_flash_bwd(torch, gen, 1, 1024, 64, False, timed=True),
               check_flash_bwd(torch, gen, 1, 64, 64, True, timed=False),
               check_flash_bwd(torch, gen, 1, 128, 128, False, timed=False)]
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "kernel_checks": checks}), flush=True)
    stamp("kernels built and checked")

    flash_kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ]
    # every path zeroes and reads all four counts
    all_kernels = flash_kernels + [ra.KERNEL]
    launches = {"serve": {}, "train": {}, "serve_mixtral": {},
                "serve_gpt2": {}, "vit": {},
                **{f"engine_{r}": {} for r in ENGINE_RUNS},
                "pd_monolithic": {}, "pd_handoff": {},
                "pd_coalesced_prefill": {}, "worker_kernels": {},
                "actor_serve": {}, "serve_http": {}, "serve_pd_http": {},
                "batch_processor": {}, "train_fit": {}, "train_resume": {},
                "train_zero_rank0": {}, "tune_trial0": {}, "tune_trial1": {},
                "device_producer": {}, "dag_engine": {},
                "follower_engine": {}, "follower_retry": {},
                "pip_env_actor": {}, "autoscaled_actor": {},
                "gce_vm_actor": {},
                "job_serve": {}, "llm_bench": {}, "rl_ppo": {}, "rl_dqn": {},
                **{f"rl_{a}": {} for a in ("impala", "appo", "sac", "bc",
                                           "marwil", "cql", "iql",
                                           "dreamerv3")},
                "mesh_train": {}, "serve_tp_rank0": {}, "serve_tp_rank1": {}}
    if not args.only_kernels:
        from ray_tpu_torch.models import llama, mixtral, transformer

        model = check_model(torch, llama.llama_config("8b"),
                            "llama-3-8b random init bf16")
        torch.cuda.empty_cache()  # phase 3's model and pools are gone
        print(json.dumps({"card": card, "model_check": model}), flush=True)
        stamp("phase 3")
        serving = serve(torch, all_kernels)
        launches["serve"] = serving["launches"]
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, "serve": serving}), flush=True)
        print(f"serve on {card}: prefill {serving['prefill_ms_mean']:.3f} ms "
              f"mean, decode step {serving['decode_step_ms_mean']:.3f} ms "
              f"mean, {serving['tokens_per_s']:.1f} tokens/s", flush=True)
        stamp("phase 4")
        grads = check_model_grads(torch, flash_kernels)
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, "model_grads": grads}), flush=True)
        stamp("phase 5")
        training = train(torch, all_kernels)
        launches["train"] = training["launches"]
        print(json.dumps({"card": card, "train": training}), flush=True)
        print(f"train on {card}: step {training['step_ms']:.3f} ms, "
              f"{training['tokens_per_sec']:.1f} tokens/s, mfu_6nd "
              f"{training['mfu_6nd']:.4f}, peak memory "
              f"{training['max_memory_allocated'] / 2**30:.2f} GiB",
              flush=True)
        del training
        torch.cuda.empty_cache()
        stamp("phase 6")
        # phase 7: Mixtral-8x7B, full width, 16 of 32 layers
        moe_model = check_model(
            torch, mixtral.mixtral_config("8x7b", n_layers=MIXTRAL_LAYERS),
            f"mixtral-8x7b {MIXTRAL_LAYERS} of 32 layers random init bf16")
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, "moe_model_check": moe_model}),
              flush=True)
        stamp("phase 7")
        # phase 8: serving Mixtral, the slice's main path
        moe_serving = serve(torch, all_kernels, "mixtral", "8x7b",
                            {"n_layers": MIXTRAL_LAYERS})
        launches["serve_mixtral"] = moe_serving["launches"]
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, "serve_mixtral": moe_serving}),
              flush=True)
        print(f"serve mixtral-8x7b ({MIXTRAL_LAYERS} layers) on {card}: "
              f"prefill {moe_serving['prefill_ms_mean']:.3f} ms mean, decode "
              f"step {moe_serving['decode_step_ms_mean']:.3f} ms mean, "
              f"{moe_serving['tokens_per_s']:.1f} tokens/s", flush=True)
        stamp("phase 8")
        # phase 9: GPT-2 served, ViT-L/16, the dispatcher on the card
        gpt2_serving = serve(torch, all_kernels, "gpt2", "124m",
                             lengths=[5, 65, 300, 900], max_len=1024)
        launches["serve_gpt2"] = gpt2_serving["launches"]
        torch.cuda.empty_cache()
        vit_check = check_vit(torch, all_kernels)
        launches["vit"] = vit_check["launches"]
        torch.cuda.empty_cache()
        dispatch = check_dispatch(torch, all_kernels)
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, "serve_gpt2": gpt2_serving,
                          "vit": vit_check, "dispatch": dispatch}),
              flush=True)
        print(f"serve gpt2-124m on {card}: prefill "
              f"{gpt2_serving['prefill_ms_mean']:.3f} ms mean, decode step "
              f"{gpt2_serving['decode_step_ms_mean']:.3f} ms mean, "
              f"{gpt2_serving['tokens_per_s']:.1f} tokens/s", flush=True)
        stamp("phase 9")
        # phase 10: the engine's options on Llama-3-8B, built once
        cfg8b = llama.llama_config("8b")
        params8b = transformer.init(
            torch.Generator(device="cuda").manual_seed(SEED), cfg8b,
            torch.device("cuda"), dtype=cfg8b.dtype)
        for name, n in serve_options(torch, all_kernels, card, cfg8b,
                                     params8b).items():
            launches[f"engine_{name}"] = n
        torch.cuda.empty_cache()
        stamp("phase 10")
        # phase 12: PD disaggregation on the same model, before phase 11
        # needs the card's memory
        pd = serve_pd(torch, all_kernels, card, cfg8b, params8b)
        for path in ("pd_monolithic", "pd_handoff", "pd_coalesced_prefill"):
            launches[path] = pd[path]
        stamp("phase 12")
        # phase 14's and 15's expected responses, on the same weights
        expected14 = http_expected(torch, cfg8b, params8b)
        expected15 = pd_expected(torch, cfg8b, params8b)
        expected16 = batch_expected(torch, cfg8b, params8b)
        expected18 = dag_expected(torch, cfg8b, params8b)
        fps10 = weight_fingerprints(torch, params8b)
        stamp("the expected responses of phases 14-18")
        del params8b
        gc.collect()  # engines that hold the 8B weights in reference cycles
        torch.cuda.empty_cache()
        # phase 13: the runtime on the card, after the driver's Llama-3-8B
        # copy is gone and before phase 11
        import ray_tpu_torch

        runtime = runtime_checks(torch, ray_tpu_torch, card, serving)
        launches["worker_kernels"] = runtime["13b"]["launches"]
        launches["actor_serve"] = runtime["13c"]["launches"]
        print(json.dumps({"card": card, "runtime": runtime}), flush=True)
        stamp("phase 13")
        # phase 14: Llama-3-8B over HTTP from a Serve replica
        http = serve_http(torch, ray_tpu_torch, card, serving, runtime,
                          expected14)
        launches["serve_http"] = http["launches"]
        print(json.dumps({"card": card, "serve_http": http}), flush=True)
        # phase 15: Llama-3-8B disaggregated over HTTP, two replicas on
        # the card, in a fresh session
        pd_http = serve_pd_http(torch, ray_tpu_torch, card, serving, http,
                                fps10, expected15)
        launches["serve_pd_http"] = pd_http["launches"]
        print(json.dumps({"card": card, "serve_pd_http": pd_http,
                          "prefill_batch_vs_prefill":
                          expected15["prefill_batch_vs_prefill"]}),
              flush=True)
        # phase 16: Llama-3-8B batch inference over Data, and Data onto
        # the card, in a fresh session
        batch = batch_phase(torch, ray_tpu_torch, card, serving, expected14,
                            expected16)
        launches["batch_processor"] = batch["launches"]
        print(json.dumps({"card": card, "batch": batch}), flush=True)
        # phase 17: Train and Tune, in a fresh session
        trained = train_phase(torch, ray_tpu_torch, all_kernels, card)
        launches["train_fit"] = trained["17a"]["launches"]
        launches["train_resume"] = trained["17b"]["launches"]
        launches["train_zero_rank0"] = trained["17c"]["fp32"]["launches"]
        for i, trial in enumerate(trained["17d"]["trials"]):
            launches[f"tune_trial{i}"] = trial["launches"]
        print(json.dumps({"card": card, "train_tune": trained}), flush=True)
        # phase 18: device objects and a compiled DAG, in a fresh session
        dagged = dag_phase(torch, ray_tpu_torch, card, expected18, fps10)
        launches["device_producer"] = dagged["18a"]["launches"]
        launches["dag_engine"] = dagged["18b"]["launches"]
        print(json.dumps({"card": card, "dag": dagged}), flush=True)
        # phase 19: multi-host, two follower hosts sharing the card
        hosted = multihost_phase(torch, ray_tpu_torch, card, expected18,
                                 fps10)
        launches["follower_engine"] = hosted["19a"]["launches"]
        launches["follower_retry"] = hosted["19c"]["launches"]
        print(json.dumps({"card": card, "multihost": hosted}), flush=True)
        # phase 20: runtime envs and the autoscaler
        scaled = autoscaler_phase(torch, ray_tpu_torch, card, expected18,
                                  fps10)
        launches["pip_env_actor"] = scaled["20a"]["launches"]
        launches["autoscaled_actor"] = scaled["20b"]["launches"]
        launches["gce_vm_actor"] = scaled["20c"]["launches"]
        print(json.dumps({"card": card, "autoscaler": scaled}), flush=True)
        # phase 21: the ops plane: Llama-3-8B from a job submitted through
        # the CLI, the dashboard, the microbenchmarks
        ops = job_phase(torch, all_kernels, card, expected14, fps10)
        launches["job_serve"] = ops["launches"]
        launches["llm_bench"] = ops["llm_bench_launches"]
        print(json.dumps({"card": card, "ops_plane": ops}), flush=True)
        # phase 23 (RLlib's model-free algorithms, learners on the card, in
        # a fresh session) in a process of its own, beside phases 22, 24
        # and 11 here: one after the other the four took 315 s of a slow
        # host's 1193.2 s (PERF.md)
        lane = Lane("23")
        try:
            # phase 22: RLlib's learners on the card and the C++ worker, in
            # a fresh session
            rl = rl_phase(torch, ray_tpu_torch, all_kernels, card)
            launches["rl_ppo"] = rl["22a"]["launches"]
            launches["rl_dqn"] = rl["22b"]["launches"]
            print(json.dumps({"card": card, "rllib": rl}), flush=True)
            # phase 24: DreamerV3, its learner on the card, in a fresh
            # session
            dreamer = dreamer_phase(torch, ray_tpu_torch, all_kernels, card)
            launches["rl_dreamerv3"] = dreamer["launches"]
            print(json.dumps({"card": card, "rllib_dreamerv3": dreamer}),
                  flush=True)
            # phase 11: multi-GPU on the one card
            meshed = mesh_train(torch, all_kernels)
            launches["mesh_train"] = meshed["launches"]
            print(json.dumps({"card": card, "mesh_train": meshed}),
                  flush=True)
            tp = serve_tp(torch, card)
            launches["serve_tp_rank0"], launches["serve_tp_rank1"] = \
                tp["launches_by_rank"]
            print(json.dumps({"card": card, "serve_tp": tp}), flush=True)
            print(f"serve llama-3-8b tp={TP} ({tp['label']}, {card}): "
                  f"prefill {tp['prefill_ms_mean']:.3f} ms mean, decode "
                  f"step {tp['decode_step_ms_mean']:.3f} ms mean",
                  flush=True)
            dry = dryrun_tp(torch)
            print(json.dumps({"card": card, "dryrun": dry}), flush=True)
            stamp("phases 22, 24 and 11")
            rl2 = lane.join()
        finally:
            lane.stop()
        launches.update(rl2["launches"])
        print(json.dumps({"card": card, "rllib_part_two": rl2}), flush=True)
        stamp("phase 23")

    def case(name):
        return next(c for c in checks if c["case"] == name)

    fwd = case("flash B=4 T=2048 D=64 causal=True")
    bwd = case("flash_bwd B=4 T=2048 D=64 causal=True")
    ragged = case("ragged P=64 pages_bound=32")
    rows = [  # kernel, its path, source, Pallas kernel, case row, numbers
        (fa.KERNEL, "train", "flash_attention_fwd.cu",
         "ray_tpu/ops/flash_attention.py:43", fwd,
         (fwd["max_abs_err"], fwd["ms"], fwd["bound_ms"], fwd["bound_by"])),
        (fa.KERNEL_DKV, "train", "flash_attention_bwd.cu",
         "ray_tpu/ops/flash_attention.py:152", bwd,
         (max(bwd["dk_max_abs_err"], bwd["dv_max_abs_err"]), bwd["dkv_ms"],
          bwd["dkv_bound_ms"], bwd["dkv_bound_by"])),
        (fa.KERNEL_DQ, "train", "flash_attention_bwd.cu",
         "ray_tpu/ops/flash_attention.py:197", bwd,
         (bwd["dq_max_abs_err"], bwd["dq_ms"], bwd["dq_bound_ms"],
          bwd["dq_bound_by"])),
        (ra.KERNEL, "serve", "ragged_paged_attention.cu",
         "ray_tpu/ops/ragged_paged_attention.py:49", ragged,
         (ragged["max_abs_err"], ragged["ms"], ragged["bound_ms"],
          ragged["bound_by"]))]
    full = case("ragged P=64 pages_bound=32 all full")
    extra = {ra.KERNEL.symbol: {  # one counted launch is two device kernels
        "device_kernels_per_launch": 2, "splits": ragged["splits"],
        "pages_per_split": ragged["pages_per_split"],
        "all_full_ms": full["ms"], "all_full_bound_ms": full["bound_ms"]}}
    kernels = []
    for kern, path, src, rep, c, (err, ms, bms, by) in rows:
        kernels.append({**extra.get(kern.symbol, {}),
            "name": kern.symbol, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": launches[path].get(kern.symbol), "path": path,
            "launches_by_path": {p: n.get(kern.symbol)  # null: not run
                                 for p, n in launches.items()},
            "case": c["case"], "max_abs_err": err, "ms": ms,
            "plain_ms": c["plain_ms"], "bound_ms": bms, "bound_by": by,
            "bound_share": bms / ms, "library_ms": c["library_ms"]})
    print(json.dumps({"card": card, "script_s": time.perf_counter() - t_script}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
