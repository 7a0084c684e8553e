#!/usr/bin/env python3
"""Drive the PyTorch port (``yoho_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --profile  # all phases; the second e2e run traced

Phases, one output line each (JSON after the phase name):

1. ``card``: name and power limit from ``nvidia-smi``, first as it prints
   them, then with the PyTorch and CUDA versions.
2. ``build``: compiles every kernel of ``yoho_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and prints the seconds.
3. ``kernel``: each kernel at the main paths' shapes on the card against
   its plain PyTorch version on the same inputs, with the stated
   tolerance; its device time per call (``torch.profiler``, L2 flushed
   between calls), the plain version's, a PyTorch library call's
   where one computes the same function (a yardstick only: the port never
   calls it), and the bound: the largest of bytes over 3.35 TB/s and the
   operations of each type over that type's peak rate (H100 SXM data
   sheet), counted for the work the design runs (the mel kernel's three
   TF32 products; its FP32-only figure beside it).
   The w8a8 cases also time two labelled yardsticks: ``torch._int_mm`` on
   the pre-quantized operands (the int8 product alone) and bf16
   ``F.linear`` (+ tanh-GELU), what the bf16 lane computes, and split the
   kernel's time into its row-quantize pass and its GEMM; the mel cases
   time a ``torch.stft`` yardstick (cuFFT, not the same rounding). Flash
   runs at whisper-small's 12, turbo's 20 and whisper-tiny's 6 heads
   (SDPA's time beside each), and at the alignment pass's causal 448 x 448
   and cross 448 x 1500; decode attention on the
   cross K/V padded to 1536 positions (kv_len 1500) as the main path
   stores them, for prefill, and on the self cache at pos 0, 200 and 447;
   beam search's folded cross read (5 queries a stream), a 224-token
   prompt's prefill on the cache and on the cross K/V, the folded beam
   prefill of that prompt (1,120 queries), the
   unpadded bf16 cross read of language detection, speculative decoding's
   5-query verify read, causal on the cache at pos 200 and 447, the
   draft's 2-query reads at 6 heads on its cache and cross K/V, and
   continuous batching's and the captured greedy programs' reads of the
   cache with one position per row (16 rows spread from 0 to 447, all at
   0, all at 200 and all at 447: beside the scalar reads at 0, 200 and 447,
   the parent's greedy route; and the 5-query verify read at spread
   positions), whose bound counts each row's valid prefix.
   Decode's reads of several bf16 queries run its tensor-core route
   (``decode_attention_mq``, one launch at any S), the others its FMA route
   (``decode_attention``): each decode line names its ``decode_route``
   (``mma`` or ``fma``) and its ``launches_per_call``, and fails if the
   other route launched.
   The YOHO family's shapes (phase e2e-yoho): the log-mel of 16 windows of
   164,080 samples (scipy framing, HTK, 128 mels, 1,024 frames), encoder
   attention (16, 512, 6, 64) on 3 KV heads unexpanded, the bf16 cross read
   (T 512) and the causal bf16 self read (T 256, pos 200) at 6 query heads
   on 3 KV heads, one query and five (a verify step); then head dim 16 (the trained fixture's) at the fixture's
   shapes and at the full-width batch; SDPA with ``enable_gqa`` beside each
   attention line. Phase e2e-yoho-train's: the teacher-forced decoder's
   causal (16, 256, 6, 64) and cross 256 x 512 flash passes, and head dims
   32 (12 heads on 6) and 128 (4 on 2) at the encoder, causal, cross and
   decode-read shapes, timed in bf16, then checked (untimed) in f32 and
   bf16 at S = 1, 4 and 32 with groups 1 and 2. Padded head dims (run at
   the smallest instantiated width that holds them): flash at the YOHO
   encoder shapes (16, 512, 8 on 4, 48) (the wgmma route at 64) and (16,
   512, 4 on 2, 96) (wgmma at 128), the bf16 cross and self reads at 48 and
   the cross read at 96; the int8 cross read at D = 8 (the JAX dry run's
   whisper, 4 heads; batch 16, T 1536, kv_len 1500); flash checked
   (untimed) at D = 8, 24, 72, 120 and 136 (FMAs at width 256), causal and
   not; decode at D = 256 (2 heads on 1), one query and five, timed, and D =
   200 (width 256) at 1, 5 and 224 queries, checked. Every flash line names its route (``flash_route``) and ``width``;
   bf16 k and v go to the kernel unexpanded, and the bound counts q, out
   and those K/V bytes. Head dims above 256 (the split route, output
   slices of width 256: ``slices`` on each line): flash (16, 512, 4 on 2,
   512) and decode's int8 cross reads at D = 512, S = 1 and 5 (T 512),
   timed, each with the extra work of its slices beside its bound (flash's
   recomputed QK products, decode's repeated K bytes); flash at D = 264
   and 512 in f32 and bf16, causal and not, and decode at D = 264 and 512
   on both routes over int8, int4 and float K/V, checked.
4. ``e2e``: whisper-small at full width with random bf16 weights from a
   seed, int8 cross-K/V and int8 self-cache, greedy decode with timestamps,
   batch 16, through ``Transcriber.transcribe_many`` on requests of 12 s,
   30 s and 75 s of synthetic audio. Checks: finite encoder output and
   logits that agree with the CPU plain path on one window, the same
   tokens on a second run, and the kernels of the path (all but w8a8)
   launched during the run. The greedy decode programs run as captured
   CUDA graphs (``infer/graphs.py``); ``_graph_checks`` then holds the
   captured program, on 16 windows of noise at ``AUTO_MAX_LEN`` positions,
   to the same chunk body run eagerly (tokens, lengths, ``sum_logprob``,
   ``no_speech_prob`` bit for bit; launches per kernel equal) on its first
   call and on a second that captures nothing, with every host sync of the
   first call between chunks (sync debug mode "warn") and the parent's
   route (``_int_pos_decode``: the same steps driven with an int ``pos``)
   left only at ties; the line's ``captured`` field gives both routes'
   walls and ms a decode step, the capture's seconds, the graph pool's
   bytes and the bytes held after the call.
5. ``e2e-int8``: the same for whisper large-v3-turbo (1280 wide, 32
   encoder and 4 decoder layers, 128 mels, vocab 51866) with its random
   bf16 weights quantized on the card into both int8 lanes
   (``encoder_int8``: W8A8 encoder MLPs through the w8a8 kernel;
   ``weights_int8``: int8 decoder weights and tied embedding) and
   ``fast_gelu``; the CPU reference is the same quantized model in f32,
   and every kernel, w8a8 included, must launch; ``_graph_checks`` as in
   ``e2e``.
6. ``e2e-options``: whisper-small at full width and depth (random bf16
   weights, int8 cross-K/V and cache, batch 16, the same three requests)
   through one ``Transcriber`` with beams 5, ``language=None``, word
   timestamps, hotwords, a logit bias, ``repetition_penalty`` 1.1,
   ``no_repeat_ngram_size`` 3 and a 224-token per-request prompt on the
   75 s request; ``transcribe_many`` twice (the same tokens and word
   timings both times), then ``condition_on_previous_text`` on the 75 s
   request. Checks: the language logits, one folded beam step's logits
   and the alignment map of one window against the CPU plain path in
   float32; a hook on the decode kernels' launches counts every read's
   (rows, queries, positions) and holds them to the beam arithmetic
   (per layer: the detection step, each batch's prefill in one launch at
   any prompt length, one self read at 80 rows and one folded cross read
   of 5 queries at 16 rows per step; no cross read at 80 rows), and each
   route's launches to the reads of one query (FMA) and of more.
   With ``--profile`` each path's second run is traced with
   ``torch.profiler`` and a ``profile`` line gives the device time of the
   top kernels and of each of the port's own kernel functions, and the
   device's busy share of the untraced run's wall time; the trace must
   hold no combine kernel (decode attention is one launch). With
   ``--profile`` phase e2e-yoho-train also traces its third stage-1
   mini-step.
7. ``e2e-files``: whisper-small as in ``e2e``, with ``vad_filter`` and
   ``hallucination_silence_threshold`` 2.0, on the same three requests
   written as files: 12 s as a stereo int16 WAV at 44.1 kHz, 30 s as a
   16-bit FLAC from the port's encoder, 75 s as a mono int16 WAV at 16 kHz
   with 20 s of zeros in the middle. Checks: the decoded samples equal the
   port's ``resample`` of the written arrays within one int16 step, the
   75 s request's speech map leaves the zeros out, the same tokens on a
   second call, every segment inside its request, and mel, flash and
   decode attention launched. It prints which decoder read the FLAC and
   the windows decoded with and without the VAD.
8. ``e2e-spec``: whisper-small (bf16, int8 cross-K/V and cache, batch 16)
   decoding speculatively at gamma 4 on the three requests, with two
   drafts: whisper-tiny with random weights from seed 1 (it mostly
   disagrees: the low-acceptance worst case) and the target itself (every
   round commits gamma + 1 tokens but at ties). Checks: one verify step's
   logits against the CPU plain path in float32; a hook on the decode
   kernels' launches holds every read to the round arithmetic (per batch the
   prompt's prefill by both models; per round and draft layer one S = 2
   step and gamma - 1 S = 1 steps at the draft's heads, then per target
   layer one 5-query verify step; each a causal read of the cache and a
   read of the cross K/V at 16 rows); one host sync per round; each row's
   tokens equal greedy's (the ``e2e`` configuration, run again with its
   processed logits recorded) up to its first difference, and there the
   greedy top-2 margin is at most 4 bf16 ulps of the larger logit. Greedy
   and both drafts decode ``SERVE_MAX_LEN`` (112) positions a window, not
   448, to fit the time limit. It
   prints per draft the wall, audio-s/s, rounds, tokens committed per
   round, host syncs, the rows that diverge and the decode launches by
   shape; ``phase-wall`` lines give each of the two phases' seconds.
9. ``e2e-serve``: whisper-small (random bf16 weights, int8 cross-K/V and
   cache, timestamps, 16 slots, ``chunk_tokens`` 16) served continuously.
   (a) ``SlotEngine`` with a fixed schedule: the 5 windows of the three
   requests in four waves, admitted before chunks 0, 1, 2 and 3 (20
   windows for 16 slots); (b) ``serve(transcriber, port=0, continuous=
   True)`` after ``warmup``, with the three requests to ``POST
   /transcribe``, the 30 s request to ``/v1/audio/transcriptions`` as
   verbose_json and srt, and a ``/stream`` WebSocket session of the 75 s
   request in 1 s frames, all at once, then the same with
   ``continuous=False`` (the micro-batcher); (c) the speculative slots,
   gamma 4 with the target as its own draft, the 5 windows admitted one
   per chunk. Every transcriber of the phase decodes ``SERVE_MAX_LEN``
   (112) positions a window, not 448, to fit the time limit. Checks:
   every decoded window equals greedy's (the ``e2e``
   configuration, one batch of every distinct window) up to its first
   difference, where greedy's top-2 margin is at most 4 bf16 ulps; a hook
   on the decode kernels' launches sees every causal read inside a chunk at
   per-row positions (16 rows; S = 5 verify reads in (c)) and none at a
   scalar one; each chunk runs under PyTorch's sync debug mode set to
   raise (no host sync inside a chunk) and each ``reap`` makes one; the
   greedy engines' chunk is captured at its first step and replayed (a
   replay passes through no Python: the reads inside chunks are the
   capture's times the chunks, and the line's ``captured`` gives the
   capture's seconds, pool bytes, replays and launches a replay);
   ``/statz`` and ``/metrics`` count the requests, the responses hold
   ``transcribe_many``'s segments where no window left greedy, and
   ``drain`` returns. It prints per part the wall and audio-s/s, the
   chunks, host syncs and slot occupancy per chunk, the requests served
   and the decode launches by (rows, queries, per-row, scalar or no
   position); a ``phase-wall`` line gives the phase's seconds.
10. ``train``: whisper-small fine-tuning on the card. First the flash
   ``autograd.Function`` in bf16 at batch 8 (encoder 1500 x 1500, decoder
   causal 448, cross 448 x 1500): its forward (the kernel) against the
   plain version, and dq, dk, dv (the recompute) against
   ``torch.autograd.grad`` through the plain version in f32, with the
   recompute's ms per call and memory, the forward's ms and SDPA's
   forward + backward ms by CUDA events (``flash-grad`` lines). Then a synthetic SRT corpus from the seed (4
   tracks of 60 s: low noise, a tone of its own pitch per word, 1-3 words
   an utterance), and ``WhisperFinetuner.run()`` on random f32
   whisper-small weights: bf16 autocast, remat, AdamW, batch 8, 2
   mini-batches per update, 6 updates (warmup 2), timestamps and
   augmentation on, validation with 2 greedy samples (decode attention on
   the int8 serving lane) at updates 3 and 6, checkpoints, the HF export.
   Checks: every update's loss finite, the first batch's loss lower after
   the run, mel, flash and decode attention launched in the run (w8a8
   not), the files written, and a fresh finetuner on the same directory
   resuming to bit-identical parameters. Then 2 updates each of
   freeze-encoder (the encoder bit-unchanged), LoRA rank 8 (the base
   bit-unchanged, the adapter file written), Adafactor, and
   ``WhisperDistiller`` (the tuned whisper-small teaching a random
   whisper-tiny). It prints the losses, ms per mini-step (synchronized;
   its median after the first), the host's batch ms, trained audio-s/s,
   ``max_memory_allocated`` and the launches of each run.
11. ``e2e-cli``: the command lines (``yoho_tpu_torch.cli``, in this
   process) on a whisper-small HF directory the port's exporter writes from
   seed-0 random f32 weights, with a GPT-2 ``vocab.json`` + ``merges.txt``
   built here (the 256 byte symbols, then merges of symbol pairs up to
   50,257 ids). ``transcribe`` of the three requests as WAV files (batch 16,
   int8 K/V, JSON): its tokens (recorded from the transcriber the command
   builds) and text equal an in-process ``Transcriber`` built from the same
   numpy params; ``transcribe --int8-weights --int8-encoder --fast-gelu``
   on one file (w8a8 launches); ``align`` with a given transcript (every
   word timed); ``evaluate`` over a two-track SRT corpus (finite WER and
   CER); ``doctor --json`` (no failed check, the card named); ``serve``'s
   ``main`` on port 0 in a thread (one ``/transcribe`` of the 30 s request:
   the tokens of ``transcribe``'s, then shutdown and drain); ``finetune``
   (2 updates at batch 2, the export transcribed by ``transcribe --hf``);
   ``distill`` (1 update to a random whisper-tiny). Each command's launches
   are counted from 0 and checked (mel, flash and, where it decodes, decode
   attention; w8a8 exactly under ``--int8-encoder``). Then the capacity
   model on the card (a ``capacity`` line): ``max_memory_allocated`` above
   the weights through log-mel, encode, int8 cross-K/V, prefill and 8
   decode steps at batch 16 and 32 for whisper-small (bf16) and
   large-v3-turbo int8; the slope per stream must be at most the model's
   predicted bytes per stream; the ``auto`` batch each resolves to.
12. ``e2e-yoho``: the YOHO family at the repo's default full width (dims
   384, 6 heads on 3 KV heads, 4 + 4 blocks, 128 mels, 1,024 frames, 256
   text positions, vocab 16,000, voiceprints of 256), seed-0 random weights
   written as a session directory (``config.toml`` from the port's
   ``DEFAULT_SESSION_TOML``, a tokenizer of exactly 16,000 ids built here,
   ``weights/asr.ckpt``) and loaded back by ``load_transcriber(session=...)``
   (bf16 weights and caches, float cross K/V, batch 16). One window through
   the card's kernels against the same model in f32 on the CPU (encoder
   output and 8 greedy steps' logits; tokens equal until a step whose f32
   margin the measured logit difference explains); ``transcribe_many`` of
   8 s, 25 s and 60 s twice (the same tokens; voiceprints of 256 unit
   vectors; ``cluster_voiceprints`` labels); ``--int8-weights`` on the 8 s
   request (its tokens' common prefix with bf16 stated); ``enroll`` of two
   names from two WAV clips, then ``transcribe --speakers`` naming
   segments; ``serve --session --continuous`` on port 0 answering one
   request with the tokens of the library's ``ContinuousBatcher``; the
   capacity model's YOHO bytes per stream against ``max_memory_allocated``
   at batch 16 and 32 and the ``auto`` batch; then the trained fixture
   (head dim 16) on the card: ``golden.json``'s text with the CPU port's
   tokens. Every part counts launches from 0: mel, flash and decode
   attention launch, w8a8 never. ``_graph_checks`` as in ``e2e`` on the
   full-width session (``captured`` on the line).
13. ``e2e-auto``: the serving path at the batch ``batch="auto"`` resolves
   to on this card (512 on an 80 GB H100), through ``load_transcriber``
   as ``transcribe --batch auto`` builds it: whisper-small (bf16, int8
   cross-K/V and cache, greedy) and large-v3-turbo with both int8 lanes
   from HF directories of seed-0 random weights the exporter writes, and
   the default YOHO session of ``e2e-yoho``. Each transcribes as many 30 s
   windows of noise from the seed (YOHO: 164,080-sample windows) as the
   batch resolves to, in one ``transcribe_many`` call decoding
   ``AUTO_MAX_LEN`` (224, ``bench.py::bench_one``'s length) positions a
   window; then whisper-small with 5 beams at its ``auto`` batch (112
   positions): the folded cross read and the B x K-row self read at the
   size users run them. Checks: one batch decoded, of the resolved size;
   ``max_memory_allocated`` above what was held at or below the capacity
   model's bytes for that batch, and the bytes per stream measured again
   between auto / 2 and auto at or below ``stream_terms``' sum; the first
   16 windows decoded again at batch 16 by the same transcriber, each row
   equal but inside a tie (greedy: ``_tie_check``; beams: the first
   difference where the two candidates' summed logprobs are within the
   same margin); the run under sync debug mode "warn", every host sync
   placed between decode steps: one early-exit check every 8 steps, none
   inside a chunk (a captured program's warm-up chunk and replays). The
   greedy cases then make a repeated call (replays only: it captures
   nothing), its peak above what was held before the first call at or
   below the capacity model's bytes too (the programs' buffers stay held
   while it encodes, which the transcriber does in row chunks), and run the
   same chunk body eagerly on the same log-mel, bit-equal to the repeated
   call's decode: both walls, the decode's ms a step, capture seconds,
   pool, workspace and held bytes. One line per case with the card: the
   resolved and decoded batch, wall, decode steps, audio-s/s, the peak
   against the prediction, the slope, the token check and the launches.
   Then ``_batch_dependence_f32``: whisper-small's widths at 2 + 2 layers
   in float32 decode the same 16 windows at batch 16 and at the batch
   whisper-small's ``auto`` resolved to (the rows equal, or each row's
   first difference). Above world 1, ``e2e-mesh`` decodes the turbo
   windows again over the mesh.
14. ``e2e-yoho-train``: a YOHO user's first path. A synthetic SRT corpus
   from the seed (6 tracks of 60 s); ``create-session``; ``run-session 0``
   (the tokenizer; its round trip checked); the script's 16,000-id
   tokenizer put at ``weights.tokenizer`` (stage 0's vocabulary on this
   corpus is about 1,300), so that ``run-session 1 --max-updates 2
   --compute-dtype bf16`` trains the full-width default model at the
   default hyperparameters (batch 16, 16 accumulated batches: 32
   mini-steps; validation after each update). Checks: two finite update
   and validation losses, the export written, mel, flash and decode
   attention launched. It prints ms per mini-step (synchronized; median
   and range after the first), trained audio-s/s, ``max_memory_allocated``,
   the validations' decode steps and the launches. The export is served by
   ``transcribe --session --rttm`` over 16 windows and the RTTM scored by
   ``score-diarization`` against one made from the SRTs (the DER after 2
   updates means nothing; it must parse). Then the default session with 8
   experts in every other block of both stacks (2 mini-steps with the
   auxiliary loss, one batch of 16 served, one MoE layer on the card
   against the CPU port in f32), and one batch of 16 each from seed-0
   random sessions at head dims 32 (dims 384, 12 heads), 48 (dims 384, 8
   heads), 96 (dims 384, 4 heads) and 128 (dims 512, 4 heads), each with
   one window against the CPU in f32 as in e2e-yoho; at 48 the flash
   ``autograd.Function`` (the kernel forward, the plain backward) against
   the CPU's f32 gradients.
   Between stage 1's serving and MoE, the rest of the session's path: the
   corpus tools (``import-corpus --speakers`` of a generic CSV of 8
   speakers x 4 clips of 3-6 s, each speaker at its own pitch, into the
   session's ``speakers/``; ``cache-corpus`` of the training corpus, the
   stage-2 dataloader's files and batches unchanged and all FLAC;
   ``split-tracks`` of one 60 s track, every subtitle whole inside one
   chunk), then ``run-session 2``, ``3`` and ``4 --max-updates 1
   --compute-dtype bf16`` at the default hyperparameters (16 mini-steps of
   batch 16 each). Checks: one finite update loss each, the three exports
   written, mel 1 and flash 6 / 4 / 16 launches per mini-step (decode 0,
   w8a8 never); stage 3's encoder at its first step equal to stage 2's
   export and stage 4's student to stage 1's, leaf for leaf; stage 4's
   teacher bit-equal to stage 3's export after the run; one stage-4
   batch's CE (2e-2 relative) and voiceprint loss (5e-2 absolute) on the
   card against the CPU port in f32. It prints per stage ms per mini-step
   (median and range after the first), trained audio-s/s,
   ``max_memory_allocated`` (and what was held before) and the launches.
   Stage 4's export (``weights.yoho``) is served by ``transcribe --session
   --rttm`` over the same 16 windows (the served weights the export's in
   bf16; segment voiceprints of 256 at unit norm, and the voiceprint head
   teacher-forced on one window) and scored by ``score-diarization``.
15. ``e2e-mesh``: the serving path over a (data, model) mesh of
   ``torch.distributed`` ranks (NCCL) at world = the cards present, at most
   4: in this process at world 1, else one process per card started with
   the launcher's environment (``--mesh-rank``; rank 0 reports). It prints
   ``world`` and the mesh. whisper-small from an HF directory the exporter
   writes (seed-0 random weights, bf16, int8 cross-K/V and cache, batch
   16) through ``load_transcriber(mesh="1xW")`` on the three requests of
   the e2e phases, after an unsharded ``load_transcriber`` of the same
   directory (plain, then mesh: one turn each since PR 15, to fit the
   time limit): the tokens equal at world 1
   (above it each decoded row equals the unsharded one up to a first
   difference inside a tie, ``_tie_check``: in bf16 each rank rounds its
   partial sums), the comm layer's collectives equal the prediction
   (``_mesh_predicted``: per encode 2 all-reduces a block, per decode step
   3 a layer, plus the embedding's reduce and the logits gather where the
   vocabulary divides the axis, 4 data gathers a batch), the walls of
   both, the peak memory above what was held under the capacity model's
   bytes a rank; ``--int8-encoder`` on the 12 s request (w8a8 launches);
   the default YOHO session at full width (one batch of 16 windows, its
   rows held as whisper's, the predicted collectives with the voiceprint
   pass); ``yoho_encode_long`` at seq W on 4,096 frames and
   ``pipeline_encode`` at pipe W with 2 microbatches, both in f32 against
   ``encode_audio`` of the same input (1e-4 of the output's magnitude),
   with their sends, receives, gathers and broadcasts counted. (d) Serving
   over the mesh, the same transcribers: rank 0 serves and the other ranks
   follow its schedule (``cli/serve.py::follow``). ``serve(sharded,
   continuous=True)`` (16 slots, ``chunk_tokens`` 16) after ``warmup``:
   the three requests to ``/transcribe`` at once, the 75 s one also as a
   ``/stream`` session in 1 s frames, and the 30 s one submitted by a
   client that goes away once a chunk has run (its slot freed at one
   chunk); the same with ``continuous=False`` (the micro-batcher); the
   speculative slots (the target as its own draft, gamma 4) on the three
   requests; the YOHO session's 16 windows as 16 requests through a
   ``ContinuousBatcher``. Each window decodes ``SERVE_MAX_LEN`` (112)
   positions, not 448 (256 for YOHO), to fit the time limit. Each chunk runs under ``set_sync_debug_mode(
   "error")``; the slot rows equal the unsharded ``ContinuousBatcher``'s
   on the same windows at world 1 (the micro-batcher's the batched greedy
   rows), the speculative rows greedy's but at ties, and above world 1
   every row is held by ``_tie_check``; the collectives equal
   ``_serve_predicted`` (per admission, per chunk step, per reap's packed
   ``data`` gather, one schedule broadcast a tick and one agreement a tick
   but the stop); the decode reads inside chunks at (rows, queries,
   per-row pos) and this rank's heads; every rank's engine stats equal;
   ``drain`` returns. It prints each engine's wall and audio-s/s beside
   ``e2e-serve``'s, the ticks and the channel's host us a tick. mel, flash
   and decode attention launch on the mesh path (w8a8 under
   ``--int8-encoder`` only); the unsharded references' launches are not
   counted. Above world 1 only, large-v3-turbo int8 (both lanes) through
   ``load_transcriber(mesh="1xW", batch="auto")`` from e2e-auto's
   directory on e2e-auto's windows: one batch of the size e2e-auto
   decoded, every row held to e2e-auto's row of the same window by
   ``_tie_check`` (``turbo_auto`` on the line; w8a8 launches). The process
   group is destroyed at the end.
16. ``e2e-mesh-train``: training over a mesh of ``torch.distributed``
   ranks (NCCL) at world = the cards present, at most 4 (in this process
   at world 1, else one ``--mesh-train-rank`` process per card; rank 0
   reports). A synthetic SRT corpus and 8 speakers from the seed, the
   default YOHO session at full width (dims 384, 6 heads on 3 KV heads,
   vocab 16,000) and 5 global batches of 16 made here. (a) ``ASRTrainer``
   (bf16 autocast, batch 16, 2 updates at 2 accumulated, one validation
   decoding its rows over ``data`` after them, 2 checkpoints, the export)
   unsharded in this process, then over the mesh ``Wx1`` (and ``2x2`` on
   four cards) on the same batches: at world 1 the update losses and
   every leaf bit-equal to the unsharded trainer's, above it the losses
   within 1e-4 relative and the update of the leaves (gathered whole)
   within ``MESH_TRAIN_UPDATE_RTOL`` of the unsharded one (bf16: each
   rank rounds its partial sums); the comm layer's collectives
   equal to ``_train_predicted``; ms per mini-step against the unsharded
   run's and ``max_memory_allocated``; the state saved with
   ``save_checkpoint_sharded`` and loaded back bit-equal. Stage 3
   (``VoiceprintTrainer``, 1 update at 2 accumulated) over ``Wx1``: the
   NT-Xent gathers over ``data``. (b) The long-context train step (2
   windows, ring over ``seq`` = W) and the GPipe step (``pipe`` = W, 2
   microbatches) in f32 against the unsharded step on the card: loss
   within 1e-5, gradients within 3e-5. (c) ``dryrun_multichip(W)``. Each
   part counts launches from 0 (mel and flash, decode in the validations
   and the dry run's serving; w8a8 never); the unsharded references'
   launches are not counted.
17. ``e2e-wide-heads``: whisper at head dim 264 (dims 528 on 2 heads, 80
   mels, 1,500 positions, the multilingual vocabulary, 2 + 2 layers),
   seed-0 random bf16 weights, int8 cross K/V and cache, batch 16: both
   attention kernels on their split route. One window's prefill (tensor
   cores) and step (FMAs) against the CPU in f32 (5e-2 relative), then
   ``transcribe_many`` of the three requests twice (``SERVE_MAX_LEN``
   positions a window): the same tokens, mel, flash and decode launched,
   every decode launch at D = 264.
18. ``kernels``: one JSON object with every kernel's numbers; launches are
   summed over the e2e paths' first runs (and the conditioning call),
   ``e2e-files``' first call, every ``e2e-spec`` and ``e2e-serve`` run, the
   ``train`` phase's runs, ``e2e-cli``'s commands, the parts of
   ``e2e-yoho``, ``e2e-auto``'s measured runs and ``e2e-yoho-train``,
   ``e2e-mesh``'s mesh runs (its
   served runs included), ``e2e-mesh-train``'s parts and
   ``e2e-wide-heads``' first run.
19. The last line: ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Needs CUDA and the
``yoho_tpu_torch`` package beside this file; imports no JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12}
SEED = 0
BATCH, ENC_CTX = 16, 1500      # the e2e batch, and encoder positions per window


def emit(phase: str, **fields) -> None:
    print(f"{phase} {json.dumps(fields, sort_keys=True)}", flush=True)


def bound(nbytes: float, ops: dict):
    """The least time (ms) for ``nbytes`` of memory traffic and ``ops``
    operations by type, each type at its own peak (tensor cores and FP32
    units run side by side): the largest of these times, and whether bytes
    or operations set it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_FLOPS[kind] for kind, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _device_us_by_kernel(run) -> dict:
    """Runs ``run`` under ``torch.profiler`` (CUDA activity only) and
    returns the device time of each kernel, memcpy and memset, in us."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            out[ev.key] = out.get(ev.key, 0.0) + ev.self_device_time_total
    return out


def _port_kernels(by_name: dict) -> dict:
    """Device ms of the port's own kernels (the functions of ``csrc/``, in
    anonymous namespaces), summed by function name."""
    out = {}
    for name, ms in by_name.items():
        m = re.search(r"\(anonymous namespace\)::(?:\w+::)*(\w+)", name)
        if m and "at::native" not in name:
            out[m.group(1)] = round(out.get(m.group(1), 0.0) + ms, 3)
    return out


def kernel_ms(fn, iters: int, flush) -> dict:
    """Device time of one call of ``fn`` per kernel name (ms), averaged
    over ``iters`` calls (host time between launches is not counted).
    ``flush`` (a buffer larger than the 50 MB L2) is rewritten before each
    call so inputs come from memory, as they do on the main path; the
    flush's own kernels are left out."""
    import torch

    fn()
    torch.cuda.synchronize()
    flush_names = set(_device_us_by_kernel(lambda: flush.zero_()))

    def body():
        for _ in range(iters):
            flush.zero_()
            fn()

    for _ in range(3):  # a trace that kept no kernel of the call is taken again
        us = _device_us_by_kernel(body)
        out = {k: v / iters / 1e3 for k, v in us.items() if k not in flush_names}
        if out:
            return out
    raise RuntimeError("the profiler recorded no kernel of the call")


def time_ms(fn, iters: int, flush) -> float:
    """The summed device time of the kernels of one call of ``fn`` (ms);
    see ``kernel_ms``."""
    return sum(kernel_ms(fn, iters, flush).values())


def event_ms(fn, iters: int) -> float:
    """ms per call of ``fn`` by CUDA events around ``iters`` back-to-back
    calls after a warm call (device time plus any launch gaps)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def yardstick_ms(fn, flush):
    """``time_ms`` of a library call that is only a yardstick: a call this
    PyTorch build refuses is reported as its error, not a failure."""
    try:
        return time_ms(fn, 20, flush)
    except RuntimeError as e:
        return f"not measured: {str(e).splitlines()[0][:160]}"


def check_close(name, got, want, rtol, atol) -> float:
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err}, rtol {rtol}, atol {atol})")
    return err


def _decode_launches(launches: dict) -> int:
    """Decode attention's launches in ``launches`` (kernel name -> count)
    over its two routes: the FMA route's single-query reads and the
    tensor-core route's multi-query reads."""
    return launches.get("decode_attention", 0) + launches.get("decode_attention_mq", 0)


def _never_launched(launches: dict, names=None, skip=()) -> list:
    """The kernels of ``names`` (default: every kernel of ``launches`` but
    ``skip``) that never launched. Decode attention counts over both routes:
    a part whose reads are all single queries, or all prefills, launches
    one of them."""
    names = [n for n in (launches if names is None else names)
             if n not in skip and n != "decode_attention_mq"]
    return [n for n in names
            if (_decode_launches(launches) if n == "decode_attention" else launches[n]) == 0]


def _hook_decode(record):
    """Calls ``record(args)`` with the C arguments of every decode-attention
    launch, on either route (both entry points take the same arguments:
    args[8] B, [9] Hq, [10] Hkv, [11] S, [13] T, [15] causal, [17] per-row
    pos), just before the launch. Returns the function that takes the hook
    off."""
    from yoho_tpu_torch.ops import decode_attention as da

    for kernel in da.KERNELS:
        def recording(*args, launch=kernel.launch):
            record(args)
            launch(*args)
        kernel.launch = recording

    def undo():
        for kernel in da.KERNELS:
            del kernel.launch
    return undo


def _decode_route_call(name: str, args):
    """Calls decode attention once on ``args``; returns its output, the
    kernel of the route it must take (``kernel_route``), the route, and that
    kernel's launches in the call. Fails if the other route launched."""
    from yoho_tpu_torch.ops import decode_attention as da

    route = da.kernel_route(args[0].shape[2], args[0].dtype)
    kernel = da.KERNEL_MQ if route == "mma" else da.KERNEL
    before = {k.name: k.launches for k in da.KERNELS}
    out = da.fused_decode_attention(*args)
    launched = {k.name: k.launches - before[k.name] for k in da.KERNELS}
    if launched[kernel.name] < 1 or sum(launched.values()) != launched[kernel.name]:
        raise AssertionError(f"{name}: launches {launched}, the {route} route expected")
    return out, kernel, route, launched[kernel.name]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def kernel_checks(card: str) -> dict:
    """Phase 3: every kernel against its plain version at the main paths'
    shapes (batch 16: whisper-small, and large-v3-turbo for the mel at 128
    and the w8a8 kernel). Returns the JSON entry per kernel."""
    import torch

    from yoho_tpu_torch.audio.filters import mel_filter_bank
    from yoho_tpu_torch.audio.frontend import log_mel_spectrogram
    from yoho_tpu_torch.nn.kv_cache import quantize_kv, quantize_kv4
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops import flash_attention as fa
    from yoho_tpu_torch.ops import mel_kernel as mk
    from yoho_tpu_torch.ops import w8a8_dense as w8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    entries = {}

    def record(kernel, case, err, ms, plain_ms, nbytes, ops, library_ms, tol, main=True,
               **extra):
        b_ms, b_by = bound(nbytes, ops)
        emit("kernel", name=kernel.name, case=case, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
             bound_from=f"{nbytes:.0f} B, " + ", ".join(
                 f"{n:.0f} {kind} ops" for kind, n in ops.items()),
             tolerance=tol, card=card, **extra)
        if main:
            entries[kernel.name] = dict(
                name=kernel.name, route="cuda",
                source=f"yoho_tpu_torch/csrc/{kernel.source}",
                replaces=kernel.replaces.split()[0], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)

    # Kernel 1: the log-mel frontend of 16 windows of 30 s, at whisper-small's
    # 80 mels and large-v3-turbo's 128.
    b, n, frames, n_fft, hop, n_freq = 16, 480_000, 3000, 400, 160, 201
    audio = torch.randn((b, n), generator=gen, device=dev) * 0.1
    kw = dict(sample_rate=16000, n_fft=n_fft, hop=hop, n_mels=80,
              mel_scale="slaney", convention="whisper", log_floor=1e-10)
    hann = torch.hann_window(n_fft, periodic=True, device=dev)
    for n_mels, main in ((80, True), (128, False)):
        kwm = dict(kw, n_mels=n_mels)
        got = mk.fused_log_mel(audio, **kwm)
        err = check_close(f"mel {n_mels}", got, log_mel_spectrogram(audio, **kwm), 1e-4, 1e-4)
        consts = mk._constants(16000, n_fft, hop, n_mels, "slaney", False)
        nnz = int(consts[1][-1])  # mel weights the sparse projection reads
        # The design's work: three TF32 products (frames x n_fft) x
        # (n_fft x 2 n_freq) on the tensor cores; the power (3 operations
        # per bin) and the sparse mel projection (2 per weight) in FP32.
        # The FP32-only figure is the same DFT on FMAs, the route of PR 1.
        tf32_ops = 3 * 2 * b * frames * n_fft * 2 * n_freq
        fp32_ops = b * frames * (3 * n_freq + 2 * nnz)
        nbytes = audio.numel() * 4 + got.numel() * 4 + sum(c.nbytes for c in consts)
        filt_t = torch.from_numpy(mel_filter_bank(16000, n_fft, n_mels, mel_scale="slaney")).to(dev)

        def stft_log_mel():
            spec = torch.stft(audio, n_fft, hop, window=hann, center=True, pad_mode="reflect",
                              return_complex=True)
            power = spec[..., :-1].abs() ** 2
            return torch.log10(torch.clamp_min(filt_t @ power, 1e-10))

        record(mk.KERNEL, f"whisper {n_mels} mels 16x480000", err,
               time_ms(lambda: mk.fused_log_mel(audio, **kwm), 20, flush),
               time_ms(lambda: log_mel_spectrogram(audio, **kwm), 5, flush),
               nbytes, {"tf32": tf32_ops, "fp32": fp32_ops}, None, "rtol 1e-4, atol 1e-4",
               main=main,
               bound_fp32_route_ms=bound(nbytes, {"fp32": 2 * b * frames * n_fft * 2 * n_freq
                                                  + fp32_ops})[0],
               yardsticks={"stft_log_mel_ms (torch.stft + |.|^2 + mel matmul + log10: "
                           "cuFFT, other rounding, (B, mels, frames) layout)":
                           yardstick_ms(stft_log_mel, flush)})
    sc = audio[:2, :16000 * 10]
    skw = dict(kw, convention="scipy", mel_scale="htk", log_floor=1e-13)
    err = check_close("mel scipy", mk.fused_log_mel(sc, **skw),
                      log_mel_spectrogram(sc, **skw), 1e-3, 2e-3)
    emit("kernel", name=mk.KERNEL.name, case="scipy 2x160000", max_abs_err=err,
         tolerance="rtol 1e-3, atol 2e-3")
    del audio, got

    # Kernel 2: encoder self-attention, (16, 1500, 12, 64) bf16, scale 1/8.
    w64 = dict(flash_route=fa.kernel_route(64), width=fa.kernel_width(64))
    shape = (16, 1500, 12, 64)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    scale = 64 ** -0.5
    got = fa.flash_attention(q, k, v, scale=scale)
    err = check_close("flash", got, fa.attention_reference(q, k, v, False, scale),
                      1e-2, 1e-2)
    err_c = check_close("flash causal", fa.flash_attention(q[:2], k[:2], v[:2], True, scale),
                        fa.attention_reference(q[:2], k[:2], v[:2], True, scale), 1e-2, 1e-2)
    emit("kernel", name=fa.KERNEL.name, case="causal 2x1500", max_abs_err=err_c,
         tolerance="rtol 1e-2, atol 1e-2", **w64)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)

    flops = 4 * 16 * 12 * 1500 * 1500 * 64
    record(fa.KERNEL, "encoder 16x1500x12x64 bf16", err,
           time_ms(lambda: fa.flash_attention(q, k, v, scale=scale), 5, flush),
           time_ms(lambda: fa.attention_reference(q, k, v, False, scale), 3, flush),
           4 * q.numel() * 2, {"bf16": flops}, time_ms(sdpa, 5, flush),
           "rtol 1e-2, atol 1e-2", **w64)
    del q, k, v
    # large-v3-turbo's encoder: 20 heads.
    q, k, v = (torch.randn((16, 1500, 20, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    err = check_close("flash turbo", fa.flash_attention(q, k, v, scale=scale),
                      fa.attention_reference(q, k, v, False, scale), 1e-2, 1e-2)
    record(fa.KERNEL, "encoder 16x1500x20x64 bf16 (large-v3-turbo)", err,
           time_ms(lambda: fa.flash_attention(q, k, v, scale=scale), 5, flush),
           time_ms(lambda: fa.attention_reference(q, k, v, False, scale), 3, flush),
           4 * q.numel() * 2, {"bf16": 4 * 16 * 20 * 1500 * 1500 * 64}, time_ms(sdpa, 5, flush),
           "rtol 1e-2, atol 1e-2", main=False, **w64)
    del q, k, v
    # whisper-tiny's encoder, the draft of phase e2e-spec: 6 heads.
    q, k, v = (torch.randn((16, 1500, 6, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    err = check_close("flash tiny", fa.flash_attention(q, k, v, scale=scale),
                      fa.attention_reference(q, k, v, False, scale), 1e-2, 1e-2)
    record(fa.KERNEL, "encoder 16x1500x6x64 bf16 (whisper-tiny, the draft)", err,
           time_ms(lambda: fa.flash_attention(q, k, v, scale=scale), 5, flush),
           time_ms(lambda: fa.attention_reference(q, k, v, False, scale), 3, flush),
           4 * q.numel() * 2, {"bf16": 4 * 16 * 6 * 1500 * 1500 * 64}, time_ms(sdpa, 5, flush),
           "rtol 1e-2, atol 1e-2", main=False, **w64)
    del q, k, v
    # The alignment pass of word timestamps (phase e2e-options): the
    # teacher-forced decoder's causal self-attention over 448 tokens and
    # its cross-attention of 448 queries over 1500 encoder positions.
    for label, tq, tk, causal in (("decoder causal 16x448x12x64 bf16", 448, 448, True),
                                  ("decoder cross 16x448 over 1500, 12 heads bf16",
                                   448, 1500, False)):
        q = torch.randn((16, tq, 12, 64), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((16, tk, 12, 64), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        err = check_close(f"flash {label}", fa.flash_attention(q, k, v, causal, scale),
                          fa.attention_reference(q, k, v, causal, scale), 1e-2, 1e-2)
        pairs = tq * (tq + 1) // 2 if causal else tq * tk

        def sdpa_tf(q=q, k=k, v=v, causal=causal):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
                scale=scale)

        record(fa.KERNEL, label, err,
               time_ms(lambda: fa.flash_attention(q, k, v, causal, scale), 20, flush),
               time_ms(lambda: fa.attention_reference(q, k, v, causal, scale), 5, flush),
               (q.numel() * 2 + k.numel() + v.numel()) * 2, {"bf16": 4 * 16 * 12 * pairs * 64},
               time_ms(sdpa_tf, 20, flush), "rtol 1e-2, atol 1e-2", main=False, **w64)
        del q, k, v

    # Kernel 3: decode reads. Cross: int8 (16, 12, 64, 1536) padded from
    # 1500 (kv_len 1500), the layout of the main path; self: int8 cache
    # (16, 12, 64, 512) read causally up to pos.
    def kv(t, heads=12):
        return (torch.randn((16, heads, 64, t), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))

    def q_of(s, heads=12):
        return (torch.randn((16, heads, s, 64), generator=gen, device=dev) * 0.35
                ).to(torch.bfloat16)

    def case(label, qq, k_, v_, ks, vs, pos, packing, kv_len=None, main=False, library=None,
             **extra):
        """One decode read against its plain version; ``pos`` None, an int,
        or a list (one position per row: continuous batching's per-row
        causal read, passed as an int32 tensor on the card)."""
        b_, h_, s_ = qq.shape[:3]
        rows = [pos] * b_ if pos is None or isinstance(pos, int) else list(pos)
        if not (pos is None or isinstance(pos, int)):
            pos = torch.tensor(rows, dtype=torch.int32, device=dev)
        args = (qq, k_, v_, ks, vs, pos, kv_len, 1, packing)
        got, kernel, route, launches = _decode_route_call(f"decode {label}", args)
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"decode {label}: non-finite output")
        err = check_close(f"decode {label}", got, da.decode_attention_reference(*args),
                          0.05, 0.02)
        # The positions this call needs, row by row: those below kv_len and
        # the row's pos + S; a causal query i reads the keys up to pos + i.
        t_all = k_.shape[3] if kv_len is None else kv_len
        t_rows = [t_all if p is None else min(t_all, p + s_) for p in rows]
        keys = sum(s_ * t_all if p is None else sum(min(t_all, p + i + 1) for i in range(s_))
                   for p in rows)
        per_pos = k_.shape[1] * k_.shape[2] * k_.element_size() * 2  # K and V of a row
        nbytes = (per_pos + (ks is not None) * 2 * h_ * 2) * sum(t_rows) \
            + 2 * qq.numel() * 2 + (0 if isinstance(pos, (int, type(None))) else 4 * b_)
        flops = 4 * h_ * keys * qq.shape[3]
        record(kernel, label, err, time_ms(lambda: da.fused_decode_attention(*args), 50, flush),
               time_ms(lambda: da.decode_attention_reference(*args), 10, flush),
               nbytes, {"bf16": flops}, library() if library else None,
               "rtol 0.05, atol 0.02", main=main, launches_per_call=launches,
               decode_route=route, **extra)

    cross = quantize_kv(*kv(1500), pad_to=128)
    case("cross int8 S=1 (T 1536, kv_len 1500)", q_of(1), cross.k_q, cross.v_q,
         cross.k_scale, cross.v_scale, None, 1, kv_len=cross.kv_len, main=True)
    case("cross int8 S=3 (prefill)", q_of(3), cross.k_q, cross.v_q, cross.k_scale,
         cross.v_scale, None, 1, kv_len=cross.kv_len)
    self_kv = quantize_kv(*kv(512))
    for pos in (0, 200, 447):
        case(f"self int8 S=1 pos={pos}", q_of(1), self_kv.k_q, self_kv.v_q,
             self_kv.k_scale, self_kv.v_scale, pos, 1)
    c4 = quantize_kv4(*kv(1500), pad_to=128)
    case("cross int4 S=1", q_of(1), c4.k_q, c4.v_q, c4.k_scale, c4.v_scale, None, 2,
         kv_len=c4.kv_len)
    kb, vb = kv(1500)
    qb = q_of(1)

    def sdpa_decode():
        return torch.nn.functional.scaled_dot_product_attention(
            qb, kb.transpose(2, 3), vb.transpose(2, 3), scale=1.0)

    case("cross bf16 S=1 (T 1500, rows through registers; language detection)", qb, kb, vb,
         None, None, None, 1, library=lambda: time_ms(sdpa_decode, 50, flush))
    # The request options' reads (phase e2e-options), each one launch of
    # the tensor-core route: beam search's cross read, 5 beams folded into
    # the queries of each stream's untiled K/V (the route's main case); a
    # 224-token prompt's prefill on the cache (causal at pos 0) and on the
    # cross K/V; the beam prefill of that prompt (5 x 224 folded queries).
    case("cross int8 folded beams S=5 (B 16, T 1536, kv_len 1500)", q_of(5), cross.k_q,
         cross.v_q, cross.k_scale, cross.v_scale, None, 1, kv_len=cross.kv_len, main=True)
    case("self int8 prefill S=224 causal pos=0 (T 512)", q_of(224), self_kv.k_q,
         self_kv.v_q, self_kv.k_scale, self_kv.v_scale, 0, 1)
    case("cross int8 prefill S=224", q_of(224), cross.k_q, cross.v_q,
         cross.k_scale, cross.v_scale, None, 1, kv_len=cross.kv_len)
    case("cross int8 folded beam prefill S=1120", q_of(1120), cross.k_q,
         cross.v_q, cross.k_scale, cross.v_scale, None, 1, kv_len=cross.kv_len)
    # Speculative decoding (phase e2e-spec): the target's verify step, 5
    # queries (gamma 4 + 1) causal on the cache at a non-zero pos (its cross
    # read is the S=5 shape above), and whisper-tiny's draft step of 2
    # queries at 6 heads on its cache and its cross K/V.
    for pos in (200, 447):
        case(f"self int8 verify S=5 causal pos={pos} (T 512)", q_of(5), self_kv.k_q,
             self_kv.v_q, self_kv.k_scale, self_kv.v_scale, pos, 1)
    # Continuous batching (phase e2e-serve): the slots' causal reads of the
    # int8 cache with one position per row: spread from 0 to 447, every row
    # at 200 (beside the scalar read at 200 above), every row at 0 (most
    # blocks of each cluster read nothing and combine as empty states), and
    # the speculative slots' 5-query verify read at spread positions.
    spread = [round(447 * i / 15) for i in range(16)]
    for label, s_, rows in (("S=1 rows spread 0..447", 1, spread),
                            ("S=1 every row at 200", 1, [200] * 16),
                            ("verify S=5 rows spread 0..442", 5, [min(p, 442) for p in spread]),
                            ("S=1 every row at 0", 1, [0] * 16),
                            ("S=1 every row at 447", 1, [447] * 16)):
        case(f"self int8 per-row pos {label} (T 512)", q_of(s_), self_kv.k_q, self_kv.v_q,
             self_kv.k_scale, self_kv.v_scale, rows, 1, per_row_pos=rows)
    draft_self = quantize_kv(*kv(512, heads=6))
    case("draft self int8 S=2 causal pos=199, 6 heads (T 512)", q_of(2, heads=6),
         draft_self.k_q, draft_self.v_q, draft_self.k_scale, draft_self.v_scale, 199, 1)
    draft_cross = quantize_kv(*kv(1500, heads=6), pad_to=128)
    case("draft cross int8 S=2, 6 heads (T 1536, kv_len 1500)", q_of(2, heads=6),
         draft_cross.k_q, draft_cross.v_q, draft_cross.k_scale, draft_cross.v_scale, None, 1,
         kv_len=draft_cross.kv_len)
    # Head dim 8 (the JAX dry run's whisper: 32 wide on 4 heads, with int8
    # cross K/V), padded to width 16: its cross read at batch 16 over T 1536.
    k8, v8 = (torch.randn((16, 4, 8, 1500), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    cross8 = quantize_kv(k8, v8, pad_to=128)
    case("D=8 cross int8 S=1, 4 heads (T 1536, kv_len 1500; width 16)",
         (torch.randn((16, 4, 1, 8), generator=gen, device=dev) * 8 ** -0.5).to(torch.bfloat16),
         cross8.k_q, cross8.v_q, cross8.k_scale, cross8.v_scale, None, 1,
         kv_len=cross8.kv_len)
    del kb, vb, qb, cross, self_kv, c4, draft_self, draft_cross, k8, v8, cross8
    _yoho_kernel_checks(card, gen, flush, record)
    _split_kernel_checks(card, gen, flush, record)

    # Kernel 4: the W8A8 encoder MLP of a batch of 16 windows (M = 24,000
    # rows): large-v3-turbo's fc1 (with the tanh GELU) and fc2, and
    # whisper-small's fc1. Weights are random at init_random's scale,
    # quantized per output channel as nn/quantize.py does.
    m = BATCH * ENC_CTX
    for label, k, n, act, main in (
            ("large-v3-turbo fc1 + GELU", 1280, 5120, "gelu_tanh", True),
            ("large-v3-turbo fc2", 5120, 1280, None, False),
            ("small fc1 + GELU", 768, 3072, "gelu_tanh", False)):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device=dev) * 0.02
        bias = torch.randn((n,), generator=gen, device=dev) * 0.02
        w_q, w_scale = w8.quantize_rows(w)
        w_scale = w_scale[:, 0].contiguous()
        args = (x, w_q, w_scale, bias)
        got = w8.w8a8_dense(*args, activation=act)
        want = w8.w8a8_dense_reference(*args, activation=act)
        # The JAX package's pin (tests/test_ops.py): one weight step x
        # max|x| x 1.1 (a 1-ulp scale difference flips an int8 round on an
        # exact half), plus one rounding of the bf16 output, and >= 98% of
        # the outputs identical.
        atol = float(w_scale.max()) * float(x.float().abs().max()) * 1.1 + 1e-5
        err = check_close(f"w8a8 {label}", got, want, 2.0 ** -8, atol)
        same = float((got.to(torch.bfloat16) == want.to(torch.bfloat16)).float().mean())
        if same <= 0.98:
            raise AssertionError(f"w8a8 {label}: only {same:.4f} of outputs identical")
        bit_identical = bool(torch.equal(got, want))
        del want
        xq = w8.quantize_rows(x)[0]
        w_bf16, b_bf16 = w.to(torch.bfloat16), bias.to(torch.bfloat16)

        def bf16_lane(act=act):
            y = torch.nn.functional.linear(x, w_bf16, b_bf16)
            return torch.nn.functional.gelu(y, approximate="tanh") if act else y

        yard = {"int_mm_ms (int8 product alone)": yardstick_ms(
                    lambda: torch._int_mm(xq, w_q.t()), flush),
                "bf16_linear_ms (F.linear" + (" + tanh-GELU)" if act else ")"):
                    yardstick_ms(bf16_lane, flush)}
        # The entry point's two launches, timed apart: the row quantize pass
        # (x read once, xq and xs written: bound by bytes) and the GEMM.
        split = kernel_ms(lambda: w8.w8a8_dense(*args, activation=act), 20, flush)
        quant_ms = sum(v for name, v in split.items() if "quantize_rows" in name)
        nbytes = m * k * 2 + n * k + 2 * n * 4 + m * n * 2
        record(w8.KERNEL, f"{label} M={m} K={k} N={n}", err, sum(split.values()),
               time_ms(lambda: w8.w8a8_dense_reference(*args, activation=act), 3, flush),
               nbytes, {"int8": 2 * m * k * n}, None,
               f"one weight step x max|x| x 1.1 = {atol:.4g}, rtol 2^-8, "
               f">= 98% identical (got {same:.4f})", main=main, yardsticks=yard,
               bit_identical=bit_identical, quantize_ms=quant_ms,
               gemm_ms=sum(split.values()) - quant_ms,
               quantize_bound_ms=bound(m * k * 3 + m * 4, {"fp32": 2 * m * k})[0])
        del x, w, xq, got, w_bf16
    return entries


def _yoho_kernel_checks(card: str, gen, flush, record) -> None:
    """The YOHO serving path's kernel shapes (phase e2e-yoho): the full-width
    model at batch 16 (the log-mel of 16 windows of 164,080 samples, scipy
    framing, HTK, 128 mels, 1,024 frames; encoder attention (16, 512, 6, 64)
    on 3 KV heads, unexpanded; the bf16 cross read over 512 positions and the
    causal bf16 self read over 256 at pos 200, 6 query heads on 3 KV heads),
    then head dim 16 at the trained fixture's shapes (batch 3: encoder 32
    positions, 4 heads on 2; cross 32, cache 128), head dims 32 and 128,
    and the padded head dims 48 and 96 (dims 384 on 8 and 4 heads). SDPA is
    the library yardstick (``enable_gqa`` on the unexpanded K/V)."""
    import torch

    from yoho_tpu_torch.audio.frontend import log_mel_spectrogram
    from yoho_tpu_torch.core.config import YOHOConfig
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops import flash_attention as fa
    from yoho_tpu_torch.ops import mel_kernel as mk

    dev = torch.device("cuda")
    sdpa_f = torch.nn.functional.scaled_dot_product_attention
    cfg = YOHOConfig()
    b, n, frames, n_freq = 16, cfg.n_samples, cfg.max_audio_len, cfg.n_fft // 2 + 1
    audio = torch.randn((b, n), generator=gen, device=dev) * 0.1
    kw = dict(sample_rate=16000, n_fft=cfg.n_fft, hop=cfg.stft_hop, n_mels=128,
              mel_scale="htk", convention="scipy", log_floor=1e-13)
    got = mk.fused_log_mel(audio, **kw)
    if got.shape != (b, frames, 128):
        raise AssertionError(f"yoho mel shape {tuple(got.shape)}")
    err = check_close("mel yoho", got, log_mel_spectrogram(audio, **kw), 1e-3, 2e-3)
    consts = mk._constants(16000, cfg.n_fft, cfg.stft_hop, 128, "htk", True)
    nnz = int(consts[1][-1])
    record(mk.KERNEL, "yoho scipy/HTK 128 mels 16x164080 (1024 frames)", err,
           time_ms(lambda: mk.fused_log_mel(audio, **kw), 20, flush),
           time_ms(lambda: log_mel_spectrogram(audio, **kw), 5, flush),
           audio.numel() * 4 + got.numel() * 4 + sum(c.nbytes for c in consts),
           {"tf32": 3 * 2 * b * frames * cfg.n_fft * 2 * n_freq,
            "fp32": b * frames * (3 * n_freq + 2 * nnz)}, None, "rtol 1e-3, atol 2e-3",
           main=False)
    del audio, got

    def flash_case(label, bq, tq, tk, heads, kvh, d, causal, dtype=torch.bfloat16,
                   timed=True):
        """k and v go to the kernel unexpanded (kvh heads); the bound counts
        q, out and those K/V bytes, what SDPA's ``enable_gqa`` reads."""
        q = torch.randn((bq, tq, heads, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((bq, tk, kvh, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        scale = d ** -0.5
        tol = 1e-2 if dtype == torch.bfloat16 else 2e-5
        before = fa.KERNEL.launches
        got = fa.flash_attention(q, k, v, causal, scale)
        if fa.KERNEL.launches != before + 1:
            raise AssertionError(f"flash {label}: the kernel did not launch")
        err = check_close(f"flash {label}", got, fa.attention_reference(q, k, v, causal, scale),
                          tol, tol)
        route = dict(flash_route=fa.kernel_route(d, dtype), width=fa.kernel_width(d, dtype))
        if not timed:
            emit("kernel", name=fa.KERNEL.name, case=label, max_abs_err=err,
                 tolerance=f"rtol {tol}, atol {tol}", **route)
            return
        pairs = tq * (tq + 1) // 2 if causal else tq * tk

        def sdpa():
            return sdpa_f(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          is_causal=causal, scale=scale, enable_gqa=True)

        record(fa.KERNEL, label, err,
               time_ms(lambda: fa.flash_attention(q, k, v, causal, scale), 20, flush),
               time_ms(lambda: fa.attention_reference(q, k, v, causal, scale), 5, flush),
               (q.numel() + k.numel()) * 2 * 2, {"bf16": 4 * bq * heads * pairs * d},
               yardstick_ms(sdpa, flush), "rtol 1e-2, atol 1e-2", main=False, **route)

    def decode_case(label, bq, heads, kvh, d, t, s, pos, dtype=torch.bfloat16, timed=True):
        qq = (torch.randn((bq, heads, s, d), generator=gen, device=dev) * d ** -0.5
              ).to(dtype)
        k, v = (torch.randn((bq, kvh, d, t), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        groups = heads // kvh
        args = (qq, k, v, None, None, pos, None, groups)
        got, kernel, route, launches = _decode_route_call(f"decode {label}", args)
        tol = (0.05, 0.02) if dtype == torch.bfloat16 else (1e-4, 1e-5)
        err = check_close(f"decode {label}", got, da.decode_attention_reference(*args), *tol)
        if not timed:
            emit("kernel", name=kernel.name, case=label, max_abs_err=err,
                 tolerance=f"rtol {tol[0]}, atol {tol[1]}", decode_route=route,
                 launches_per_call=launches)
            return
        t_row = t if pos is None else min(t, pos + s)
        keys = bq * (s * t if pos is None else sum(min(t, pos + i + 1) for i in range(s)))
        nbytes = 2 * bq * kvh * d * t_row * 2 + 2 * qq.numel() * 2

        def sdpa():
            mask = None
            if pos is not None:
                mask = (torch.arange(t, device=dev)[None, :]
                        <= pos + torch.arange(s, device=dev)[:, None])
            return sdpa_f(qq, k.transpose(2, 3), v.transpose(2, 3), attn_mask=mask,
                          scale=1.0, enable_gqa=True)

        record(kernel, label, err, time_ms(lambda: da.fused_decode_attention(*args), 50, flush),
               time_ms(lambda: da.decode_attention_reference(*args), 10, flush),
               nbytes, {"bf16": 4 * heads * keys * d}, yardstick_ms(sdpa, flush),
               "rtol 0.05, atol 0.02", main=False, launches_per_call=launches,
               decode_route=route)

    flash_case("yoho encoder 16x512x6x64 on 3 KV heads, bf16", 16, 512, 512, 6, 3, 64,
               False)
    decode_case("yoho cross bf16 S=1, 6 on 3 heads (T 512)", 16, 6, 3, 64, 512, 1, None)
    decode_case("yoho self bf16 S=1 causal pos=200, 6 on 3 heads (T 256)", 16, 6, 3, 64, 256,
                1, 200)
    # Several queries of a KV head's two query heads on tensor cores: a
    # verify step's 5 over the cross K/V and causal on the cache.
    decode_case("yoho cross bf16 S=5, 6 on 3 heads (T 512)", 16, 6, 3, 64, 512, 5, None)
    decode_case("yoho self bf16 S=5 causal pos=200, 6 on 3 heads (T 256)", 16, 6, 3, 64, 256,
                5, 200)
    # Head dim 16 (the wgmma route at width 16), the trained fixture at batch 3.
    flash_case("D=16 fixture encoder 3x32x4x16 on 2 KV heads, bf16", 3, 32, 32, 4, 2, 16,
               False)
    flash_case("D=16 fixture decoder causal 3x16x4x16, bf16", 3, 16, 16, 4, 2, 16, True)
    decode_case("D=16 fixture cross bf16 S=1, 4 on 2 heads (T 32)", 3, 4, 2, 16, 32, 1, None)
    decode_case("D=16 fixture self bf16 S=1 causal pos=10, 4 on 2 heads (T 128)", 3, 4, 2,
                16, 128, 1, 10)
    # Head dim 16 at the full-width batch, where the time is more than the
    # launch: the encoder shape and the cross read with 16-wide heads.
    flash_case("D=16 encoder 16x512x24x16 on 12 KV heads, bf16", 16, 512, 512, 24, 12, 16,
               False)
    decode_case("D=16 cross bf16 S=1, 24 on 12 heads (T 512)", 16, 24, 12, 16, 512, 1, None)
    # Stage-1 training's teacher-forced decoder (phase e2e-yoho-train): the
    # causal self pass (16, 256, 6, 64) and the cross pass 256 x 512.
    flash_case("yoho train decoder causal 16x256x6x64 on 3 KV heads, bf16", 16, 256, 256, 6,
               3, 64, True)
    flash_case("yoho train decoder cross 16x256x512x6x64 on 3 KV heads, bf16", 16, 256, 512,
               6, 3, 64, False)
    # Head dims 32 (dims 384 on 12 heads, 6 KV heads) and 128 (dims 512 on 4
    # heads, 2 KV heads): the wgmma flash route at widths 32 and 128 (f32 on
    # FMAs), float K/V in decode attention.
    for d, heads in ((32, 12), (128, 4)):
        kvh = heads // 2
        flash_case(f"D={d} encoder 16x512x{heads}x{d} on {kvh} KV heads, bf16", 16, 512, 512,
                   heads, kvh, d, False)
        flash_case(f"D={d} decoder causal 16x256x{heads}x{d}, bf16", 16, 256, 256, heads, kvh,
                   d, True)
        flash_case(f"D={d} decoder cross 16x256x512x{heads}x{d}, bf16", 16, 256, 512, heads,
                   kvh, d, False)
        decode_case(f"D={d} cross bf16 S=1, {heads} on {kvh} heads (T 512)", 16, heads, kvh,
                    d, 512, 1, None)
        decode_case(f"D={d} self bf16 S=1 causal pos=200, {heads} on {kvh} heads (T 256)", 16,
                    heads, kvh, d, 256, 1, 200)
        # Every type and query instantiation, groups 1 and 2 (checks only).
        flash_case(f"D={d} encoder 4x512x{heads}x{d}, f32", 4, 512, 512, heads, kvh, d, False,
                   torch.float32, timed=False)
        flash_case(f"D={d} causal 4x256x{heads}x{d}, f32", 4, 256, 256, heads, kvh, d, True,
                   torch.float32, timed=False)
        for dtype in (torch.float32, torch.bfloat16):
            for s_, pos in ((1, None), (4, 100), (32, 200)):
                for g in (1, 2):
                    decode_case(f"D={d} {str(dtype)[6:]} S={s_} pos={pos} groups {g} (T 256)",
                                4, 2 * g, 2, d, 256, s_, pos, dtype, timed=False)
    # Padded head dims, dims 384 on 8 heads (48: the wgmma route at width 64,
    # TMA zero-filling columns 48-63) and on 4 heads (96: wgmma at width 128).
    flash_case("D=48 encoder 16x512x8x48 on 4 KV heads, bf16 (width 64)", 16, 512, 512, 8, 4,
               48, False)
    flash_case("D=96 encoder 16x512x4x96 on 2 KV heads, bf16 (width 128)", 16, 512, 512, 4, 2,
               96, False)
    # Checks (untimed) at every width's padded head dims (8 at 16, 24 at 32,
    # 72 and 120 at 128) and at 136, which TMA cannot take (FMAs at width
    # 256), causal and not, grouped.
    for d in (8, 24, 72, 120, 136):
        for causal in (False, True):
            flash_case(f"D={d} {'causal ' if causal else ''}4x300x6x{d} on 2 KV heads, bf16",
                       4, 300, 300, 6, 2, d, causal, timed=False)
    decode_case("D=48 cross bf16 S=1, 8 on 4 heads (T 512; width 64)", 16, 8, 4, 48, 512, 1,
                None)
    decode_case("D=48 self bf16 S=1 causal pos=200, 8 on 4 heads (T 256; width 64)", 16, 8, 4,
                48, 256, 1, 200)
    decode_case("D=96 cross bf16 S=1, 4 on 2 heads (T 512; width 128)", 16, 4, 2, 96, 512, 1,
                None)
    # Head dim 256 (dims 512 on 2 heads, 1 KV head), decode's widest width:
    # one query on FMAs, five on tensor cores; 200 padded to it, checked.
    for s_ in (1, 5):
        decode_case(f"D=256 cross bf16 S={s_}, 2 on 1 heads (T 512)", 16, 2, 1, 256, 512, s_,
                    None)
    for s_, pos in ((1, 200), (5, 100), (224, 0)):
        decode_case(f"D=200 bf16 S={s_} pos={pos}, 4 on 2 heads (T 256; width 256)", 4, 4, 2,
                    200, 256, s_, pos, timed=False)


def _split_kernel_checks(card: str, gen, flush, record) -> None:
    """Head dims above 256, the split route of both attention kernels
    (output slices of width 256; flash's rest at the smallest FMA width that
    holds it). Timed: flash (16, 512, 4 on 2, 512) in bf16 with SDPA beside
    it, and decode's int8 cross reads at D = 512, S = 1 (FMAs) and S = 5
    (tensor cores), 4 on 2 heads over T 512; each bound counts the work of
    one pass and the line names the extra work of the slices (flash
    recomputes the scores once a slice: (slices - 1) x the QK products;
    decode reads K once a slice: (slices - 1) x K's bytes). Checked
    (untimed) against the plain versions: flash at D = 264 (slices 256 +
    16) and 512 in f32 and bf16, causal and not, 4 on 2 heads; decode at D
    = 264 and 512 over int8, int4 and float K/V, on the FMA route (bf16 S =
    1, f32 S = 1 and 5) and the tensor-core route (bf16 S = 5 and 224), no,
    scalar and per-row pos, groups 2."""
    import torch

    from yoho_tpu_torch.nn.kv_cache import quantize_kv, quantize_kv4
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    sdpa_f = torch.nn.functional.scaled_dot_product_attention
    for d in (264, 512):  # flash, checked
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q = torch.randn((4, 300, 4, d), generator=gen, device=dev).to(dtype)
                k, v = (torch.randn((4, 300, 2, d), generator=gen, device=dev).to(dtype)
                        for _ in range(2))
                tol = 1e-2 if dtype == torch.bfloat16 else 2e-5
                before = fa.KERNEL.launches
                got = fa.flash_attention(q, k, v, causal, d ** -0.5)
                if fa.KERNEL.launches != before + 1:
                    raise AssertionError(f"flash D={d}: the kernel did not launch once")
                label = f"D={d} {'causal ' if causal else ''}4x300x4 on 2 KV heads, " \
                        f"{str(dtype)[6:]}"
                err = check_close(f"flash {label}", got,
                                  fa.attention_reference(q, k, v, causal, d ** -0.5), tol, tol)
                emit("kernel", name=fa.KERNEL.name, case=label, max_abs_err=err,
                     tolerance=f"rtol {tol}, atol {tol}", flash_route=fa.kernel_route(d, dtype),
                     slices=fa.kernel_slices(d, dtype))
    for d in (264, 512):  # decode, checked
        for kind in ("int8", "int4", "float"):
            for q_dtype, s_ in ((torch.bfloat16, 1), (torch.float32, 1), (torch.float32, 5),
                                (torch.bfloat16, 5), (torch.bfloat16, 224)):
                kf, vf = (torch.randn((4, 2, d, 300), generator=gen, device=dev)
                          for _ in range(2))
                if kind == "float":
                    kv = (kf.to(q_dtype), vf.to(q_dtype), None, None, 1)
                else:
                    qkv = (quantize_kv if kind == "int8" else quantize_kv4)(
                        kf.to(torch.bfloat16), vf.to(torch.bfloat16))
                    kv = (qkv.k_q, qkv.v_q, qkv.k_scale, qkv.v_scale, qkv.packing)
                for pos in (None, 50, "rows"):
                    qq = (torch.randn((4, 4, s_, d), generator=gen, device=dev) * d ** -0.5
                          ).to(q_dtype)
                    p_ = torch.tensor([0, 20, 40, 300 - s_], dtype=torch.int32, device=dev) \
                        if pos == "rows" else pos
                    args = (qq, *kv[:4], p_, None, 2, kv[4])
                    label = f"D={d} {kind} {str(q_dtype)[6:]} S={s_} pos={pos} 4 on 2 (T 300)"
                    got, kernel, route, launches = _decode_route_call(f"decode {label}", args)
                    tol = (0.05, 0.02) if q_dtype == torch.bfloat16 else (1e-4, 1e-5)
                    err = check_close(f"decode {label}", got,
                                      da.decode_attention_reference(*args), *tol)
                    emit("kernel", name=kernel.name, case=label, max_abs_err=err,
                         tolerance=f"rtol {tol[0]}, atol {tol[1]}", decode_route=route,
                         launches_per_call=launches, slices=da.kernel_slices(d, kind))

    # Timed: flash (16, 512, 4 on 2, 512), bf16.
    b, t, heads, kvh, d = 16, 512, 4, 2, 512
    q = torch.randn((b, t, heads, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, t, kvh, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    scale = d ** -0.5
    err = check_close("flash split", fa.flash_attention(q, k, v, False, scale),
                      fa.attention_reference(q, k, v, False, scale), 1e-2, 1e-2)
    slices = fa.kernel_slices(d)

    def sdpa():
        return sdpa_f(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale,
                      enable_gqa=True)

    qk = 2 * b * heads * t * t * d  # the QK products of one pass (PV as many)
    record(fa.KERNEL, f"D={d} encoder {b}x{t}x{heads}x{d} on {kvh} KV heads, bf16 (split)",
           err, time_ms(lambda: fa.flash_attention(q, k, v, False, scale), 10, flush),
           time_ms(lambda: fa.attention_reference(q, k, v, False, scale), 3, flush),
           (q.numel() + k.numel()) * 2 * 2, {"bf16": 2 * qk}, yardstick_ms(sdpa, flush),
           "rtol 1e-2, atol 1e-2", main=False, flash_route=fa.kernel_route(d), slices=slices,
           split_extra_qk_ops=(len(slices) - 1) * qk)
    del q, k, v
    # Timed: decode's int8 cross reads at D = 512, 4 on 2 heads, T 512.
    kf, vf = (torch.randn((b, kvh, d, t), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    cross = quantize_kv(kf, vf)
    slices = da.kernel_slices(d, "int8")
    for s_ in (1, 5):
        qq = (torch.randn((b, heads, s_, d), generator=gen, device=dev) * d ** -0.5
              ).to(torch.bfloat16)
        args = (qq, cross.k_q, cross.v_q, cross.k_scale, cross.v_scale, None, None, heads // kvh)
        got, kernel, route, launches = _decode_route_call(f"decode split S={s_}", args)
        err = check_close(f"decode split S={s_}", got, da.decode_attention_reference(*args),
                          0.05, 0.02)
        k_bytes = b * kvh * d * t  # int8 codes of K
        nbytes = 2 * k_bytes + 2 * b * kvh * t * 2 + 2 * qq.numel() * 2
        record(kernel, f"D={d} cross int8 S={s_}, {heads} on {kvh} heads (T {t}; split)", err,
               time_ms(lambda: da.fused_decode_attention(*args), 50, flush),
               time_ms(lambda: da.decode_attention_reference(*args), 10, flush),
               nbytes, {"bf16": 4 * b * heads * s_ * t * d}, None, "rtol 0.05, atol 0.02",
               main=False, launches_per_call=launches, decode_route=route, slices=slices,
               split_extra_k_bytes=(len(slices) - 1) * k_bytes)
    del kf, vf, cross


class _IdText:
    """A text backend of numbers: random weights have no vocabulary, so
    every id is a word written as its number (with the byte-BPE space
    marker on its piece)."""

    def encode(self, text):
        return [int(w) for w in text.split()]

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    def convert_ids_to_tokens(self, ids):
        return [f"\u0120{int(i)}" for i in ids]


def _profiled(fn):
    """Runs ``fn`` with its device activity traced; returns its result and
    the device time per kernel name (ms)."""
    box = []
    us = _device_us_by_kernel(lambda: box.append(fn()))
    return box[0], {k: v / 1e3 for k, v in us.items()}


SPEC_GAMMA = 4
# The decode horizon of e2e-serve's runs, e2e-mesh's served runs, e2e-spec
# and e2e-wide-heads: whisper-small's 448 and the YOHO session's 256 cut to
# 112 positions a window (random weights decode to the horizon), so that
# the script fits its time limit.
SERVE_MAX_LEN = 112


def _requests():
    """The three requests of the e2e phases: 12 s, 30 s and 75 s of noise
    from the seed."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [(0.1 * rng.standard_normal(s * 16000)).astype(np.float32) for s in (12, 30, 75)]


# The two e2e paths: (phase, preset, int8 lanes, fast_gelu, v3 token table,
# reference tolerance on the encoder output and the logits).
PATHS = (
    ("e2e", "small", False, False, False, (3e-2, 5e-2)),
    # On the card the W8A8 MLPs quantize bf16 activations, on the CPU f32
    # ones: codes near an exact half differ, so the two drift apart more
    # than in bf16 alone.
    ("e2e-int8", "large-v3-turbo", True, True, True, (5e-2, 5e-2)),
)


def _emit_profile(phase: str, runs, by_name: dict, card: str,
                  run: str = "second run, device activity traced", **extra) -> None:
    """The ``profile`` line of a traced run (``runs[1]``): device busy time
    against the untraced run's wall (``runs[0]``), the top kernels, the
    port's kernels."""
    # Decode attention is one launch per call: no second combine pass.
    if any("combine" in name for name in by_name):
        raise AssertionError(f"{phase}: a combine kernel ran: {sorted(by_name)}")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit("profile", path=phase, run=run,
         traced_wall_ms=runs[1][0] * 1e3, untraced_wall_ms=runs[0][0] * 1e3,
         device_busy_ms=busy, device_busy_share=busy / (runs[0][0] * 1e3),
         top_device_ms={k[:90]: round(v, 3) for k, v in top},
         port_kernels_ms=_port_kernels(by_name), card=card, **extra)


def e2e(card: str, kernels, phase: str, preset: str, int8: bool, fast_gelu: bool,
        v3: bool, tol, trace: bool = False) -> dict:
    """Phases 4 and 5: one whisper model served end to end through the
    port; returns the launches of its first run."""
    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.quantize import quantize_whisper_decoder, quantize_whisper_encoder
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    cfg = WHISPER_PRESETS[preset]
    model = init_random(Whisper(cfg, dtype=torch.bfloat16, fast_gelu=fast_gelu), seed=SEED)
    if int8:  # the card quantizes its own random bf16 weights
        quantize_whisper_decoder(quantize_whisper_encoder(model))
    lanes = dict(weights_int8=model.weights_int8, encoder_int8=model.encoder_int8,
                 fast_gelu=fast_gelu)
    table = WhisperTokenTable(multilingual=True, v3=v3, text_backend=_IdText())
    if table.n_vocab != cfg.n_vocab:
        raise AssertionError(f"token table of {table.n_vocab} ids for a {cfg.n_vocab} vocab")
    seconds = (12, 30, 75)
    audios = _requests()

    # Reference on a small input: one window through the card's kernels
    # against the CPU plain path in float32 with the same weights (the same
    # int8 codes and scales where the lanes are on).
    with torch.inference_mode():
        window = np.zeros((1, cfg.n_samples), np.float32)
        window[0, :len(audios[0])] = audios[0][:cfg.n_samples]
        mel = fused_whisper_log_mel(torch.as_tensor(window, device="cuda"), cfg.n_mels)
        xa = model.encode_audio(mel)
        prompt = torch.as_tensor([table.sot_sequence("en")], device="cuda")
        logits, _ = model.decode_step(prompt, model.init_caches(1, quantized=True),
                                      model.cross_kvs(xa, "int8"), 0)
        if not (torch.isfinite(xa).all() and torch.isfinite(logits).all()):
            raise AssertionError("non-finite encoder output or logits")
        if xa.shape != (1, cfg.n_audio_ctx, cfg.n_audio_state) \
                or logits.shape != (1, 3, cfg.n_vocab):
            raise AssertionError(f"shapes {tuple(xa.shape)}, {tuple(logits.shape)}")
        ref = Whisper(cfg, dtype=torch.float32, device="cpu", **lanes)
        ref.load_state_dict({k: (v.float() if v.is_floating_point() else v).cpu()
                             for k, v in model.state_dict().items()})
        xa_ref = ref.encode_audio(mel.cpu())
        logits_ref, _ = ref.decode_step(prompt.cpu(), ref.init_caches(1),
                                        ref.cross_kvs(xa_ref), 0)
        rel_xa = float((xa.float().cpu() - xa_ref).norm() / xa_ref.norm())
        rel_lg = float((logits.cpu() - logits_ref).norm() / logits_ref.norm())
        if rel_xa > tol[0] or rel_lg > tol[1]:
            raise AssertionError(f"{phase}: card vs CPU reference: encoder rel err "
                                 f"{rel_xa}, logits rel err {rel_lg}")
        emit("reference", path=phase, window=1, encoder_rel_err=rel_xa,
             logits_rel_err=rel_lg,
             tolerance=f"encoder {tol[0]}, logits {tol[1]} (bf16 card vs f32 CPU)")
        del ref, xa_ref, logits_ref

    tr = Transcriber(model, token_table=table, batch_size=BATCH,
                     quantized_cross_kv="int8", quantized_cache=True,
                     cache_dtype=torch.bfloat16)
    runs = []
    for i in range(2):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if trace and i == 1:
            results, by_name = _profiled(lambda: tr.transcribe_many(audios))
        else:
            results = tr.transcribe_many(audios)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append((wall, results, {k.name: k.launches for k in kernels}))
    if trace:
        _emit_profile(phase, runs, by_name, card)
    (wall, results, launches), (wall2, results2, _) = runs
    toks = [[t for s in r.segments for t in s.tokens] for r in results]
    if toks != [[t for s in r.segments for t in s.tokens] for r in results2]:
        raise AssertionError(f"{phase}: second run gave other tokens")
    windows = sum(len(chunk_audio(a, tr.chunk_samples, tr.stride_samples)[1])
                  for a in audios)
    batches = -(-windows // BATCH)
    # The W8A8 kernel runs twice per encoder block per batch on the int8
    # lane, and never otherwise; every other kernel runs on both paths.
    want_w8a8 = 2 * cfg.n_audio_layer * batches if model.encoder_int8 else 0
    idle = _never_launched(launches, skip=(W8A8.name,))
    if idle or launches[W8A8.name] != want_w8a8:
        raise AssertionError(f"{phase}: kernels never launched: {idle}; w8a8 "
                             f"{launches[W8A8.name]} launches, {want_w8a8} expected")
    n_tok = sum(len(t) for t in toks)
    # Two decode-attention launches (self, cross) per layer per step.
    steps = _decode_launches(launches) // (2 * cfg.n_text_layer * batches)
    # The captured program against its eager body and the parent's route,
    # on 16 windows of noise (the runs above are captured programs too).
    captured = _graph_checks(phase, f"whisper-{preset}", tr,
                             _auto_windows(BATCH, tr.chunk_samples), kernels,
                             cfg.n_text_layer)
    emit(phase, model=f"whisper-{preset}", lanes=lanes, batch=BATCH,
         requests=list(seconds), windows=windows, wall_s=wall, wall_s_second_run=wall2,
         audio_s_per_s=sum(seconds) / wall, segment_tokens=n_tok,
         tokens_per_s=n_tok / wall, decode_steps=steps,
         batch_tokens_per_s=BATCH * steps * batches / wall, launches=launches,
         captured=captured, card=card)
    return launches


def e2e_wide_heads(card: str, kernels) -> dict:
    """Phase e2e-wide-heads: whisper at head dim 264, past both attention
    kernels' widest width (dims 528 on 2 heads: the split route). 80 mels,
    1,500 encoder positions, the multilingual vocabulary, 2 + 2 layers (no
    preset has this width: depth cut to keep the phase short), seed-0 random
    bf16 weights, int8 cross K/V and cache, batch 16. One window's prefill
    of the SOT sequence (tensor cores) and one step (FMAs) against the CPU's
    plain path in f32 with the same weights (5e-2 relative norm, the card
    tests'); then ``transcribe_many`` of the three requests twice, each
    window decoding ``SERVE_MAX_LEN`` positions: the same tokens both times,
    mel, flash and decode attention launched (w8a8 never), every decode
    launch at head dim 264. Returns the first run's launches."""
    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WhisperConfig
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops import flash_attention as fa
    from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    phase = "e2e-wide-heads"
    cfg = WhisperConfig(n_mels=80, n_audio_ctx=1500, n_audio_state=528, n_audio_head=2,
                        n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_state=528,
                        n_text_head=2, n_text_layer=2)
    d = cfg.n_text_state // cfg.n_text_head
    model = init_random(Whisper(cfg, dtype=torch.bfloat16), seed=SEED)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    audios = _requests()
    with torch.inference_mode():
        window = np.zeros((1, cfg.n_samples), np.float32)
        window[0, :len(audios[0])] = audios[0][:cfg.n_samples]
        mel = fused_whisper_log_mel(torch.as_tensor(window, device="cuda"), cfg.n_mels)
        prompt = torch.as_tensor([table.sot_sequence("en")])
        step = torch.as_tensor([[table.sot_sequence("en")[-1]]])
        ref = Whisper(cfg, dtype=torch.float32, device="cpu")
        ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})

        def run(m, dev, quantized):
            xa = m.encode_audio(mel.to(dev, m.dtype))
            caches = m.init_caches(1, None, None, quantized)
            kvs = m.cross_kvs(xa, "int8" if quantized else False)
            first = m.decode_step(prompt.to(dev), caches, kvs, 0)[0]
            return first, m.decode_step(step.to(dev), caches, kvs, prompt.shape[1])[0]

        errs = []
        for g, w in zip(run(model, "cuda", True), run(ref, "cpu", False)):
            g = g.float().cpu()
            if not torch.isfinite(g).all():
                raise AssertionError(f"{phase}: non-finite logits")
            errs.append(float((g - w).norm() / w.norm()))
        if max(errs) > 5e-2:
            raise AssertionError(f"{phase}: card vs CPU logits rel err {errs}")
        emit("reference", path=phase, window=1, prefill_logits_rel_err=errs[0],
             step_logits_rel_err=errs[1], tolerance="5e-2 (bf16 card vs f32 CPU)")
        del ref

    tr = Transcriber(model, token_table=table, batch_size=BATCH, quantized_cross_kv="int8",
                     quantized_cache=True, cache_dtype=torch.bfloat16)
    tr.max_len = SERVE_MAX_LEN
    head_dims = set()
    undo = _hook_decode(lambda args: head_dims.add(args[12]))
    runs = []
    try:
        for _ in range(2):
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = tr.transcribe_many(audios)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, results,
                         {k.name: k.launches for k in kernels}))
    finally:
        undo()
    (wall, results, launches), (wall2, results2, _) = runs
    toks = [[t for s in r.segments for t in s.tokens] for r in results]
    if toks != [[t for s in r.segments for t in s.tokens] for r in results2]:
        raise AssertionError(f"{phase}: second run gave other tokens")
    idle = _never_launched(launches, skip=(W8A8.name,))
    if idle or launches[W8A8.name] or head_dims != {d}:
        raise AssertionError(f"{phase}: never launched {idle}, w8a8 {launches[W8A8.name]}, "
                             f"decode head dims {sorted(head_dims)}")
    emit(phase, model=f"whisper, dims {cfg.n_text_state} on {cfg.n_text_head} heads (D {d}), "
                      f"{cfg.n_audio_layer} + {cfg.n_text_layer} layers",
         flash_route=fa.kernel_route(d), flash_slices=fa.kernel_slices(d),
         decode_slices=da.kernel_slices(d, "int8"), batch=BATCH, requests=[12, 30, 75],
         max_len=SERVE_MAX_LEN, wall_s=wall, wall_s_second_run=wall2,
         segment_tokens=sum(len(t) for t in toks), launches=launches, card=card)
    return launches


def _rel_err(got, want) -> float:
    import torch

    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    return float((got - want).norm() / want.norm())


def e2e_options(card: str, kernels, trace: bool = False) -> dict:
    """Phase 6: whisper-small served with the request options (beam search
    over the untiled cross-K/V, language detection, word timestamps, logit
    bias, hotwords, repetition rules, a 224-token per-request prompt), then
    previous-text conditioning; returns the launches of its runs."""
    from collections import Counter

    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops import decode_attention as da
    from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    phase, beams = "e2e-options", 5
    cfg = WHISPER_PRESETS["small"]
    layers = cfg.n_text_layer
    model = init_random(Whisper(cfg, dtype=torch.bfloat16), seed=SEED)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    rng = np.random.default_rng(SEED)
    seconds = (12, 30, 75)
    audios = [(0.1 * rng.standard_normal(s * 16000)).astype(np.float32) for s in seconds]
    # 230 ids, of which the prompt keeps the last 220: with <|startofprev|>
    # and the SOT sequence, 224 tokens, the per-request prompt budget.
    prompts = [None, None, " ".join(str(int(i)) for i in rng.integers(1000, 50000, 230))]
    options = dict(language=None, word_timestamps=True, hotwords="1000 1001, 2000",
                   logit_bias={3000: 2.0, 4000: -1.0}, repetition_penalty=1.1,
                   no_repeat_ngram_size=3)
    serving = dict(quantized_cross_kv="int8", quantized_cache=True,
                   cache_dtype=torch.bfloat16)
    tr = Transcriber(model, token_table=table, batch_size=BATCH, beams=beams, **options,
                     **serving)

    # Reference on one window: the language logits, one folded beam step and
    # the alignment map from the card against the CPU plain path in float32
    # with the same weights (float cross-K/V and cache there).
    tol = 5e-2
    with torch.inference_mode():
        window = np.zeros((1, cfg.n_samples), np.float32)
        window[0, :len(audios[0])] = audios[0][:cfg.n_samples]
        ref = Whisper(cfg, dtype=torch.float32, device="cpu")
        ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        ref_tr = Transcriber(ref, token_table=table, batch_size=1, beams=beams,
                             device="cpu", **options)
        lang_logits = tr._language_logits(window)
        lang_ref = ref_tr._language_logits(window)
        mel = fused_whisper_log_mel(torch.as_tensor(window, device="cuda"), cfg.n_mels)
        xa, xa_ref = model.encode_audio(mel), ref.encode_audio(mel.cpu())
        prompt = torch.as_tensor([table.sot_sequence("en")] * beams)
        step = torch.as_tensor([[100 * (j + 1)] for j in range(beams)])

        def beam_step(m, ckv, caches, dev):
            m.decode_step(prompt.to(dev), caches, ckv, 0)
            return m.decode_step(step.to(dev), caches, ckv, prompt.shape[1])[0]

        # The cross-K/V of the one window, untiled: the 5 beams fold into
        # its queries.
        beam_logits = beam_step(model, model.cross_kvs(xa, "int8"),
                                model.init_caches(beams, torch.bfloat16, None, True), "cuda")
        beam_ref = beam_step(ref, ref.cross_kvs(xa_ref), ref.init_caches(beams), "cpu")
        tokens = torch.full((1, cfg.n_text_ctx), table.eot)
        forced = table.sot_sequence("en") + [int(i) for i in rng.integers(1000, 50000, 200)]
        tokens[0, :len(forced)] = torch.as_tensor(forced)
        amap = model.cross_attention_map(tokens.cuda(), xa)
        amap_ref = ref.cross_attention_map(tokens, xa_ref)
        errs = dict(language_logits_rel_err=_rel_err(lang_logits, lang_ref),
                    beam_step_logits_rel_err=_rel_err(beam_logits, beam_ref),
                    alignment_map_rel_err=_rel_err(amap, amap_ref))
        finite = all(bool(torch.isfinite(torch.as_tensor(x)).all())
                     for x in (lang_logits, beam_logits, amap))
        shapes_ok = (lang_logits.shape == (1, cfg.n_vocab)
                     and beam_logits.shape == (beams, 1, cfg.n_vocab)
                     and amap.shape == (1, cfg.n_text_ctx, cfg.n_audio_ctx))
        emit("reference", path=phase, window=1, **errs,
             tolerance=f"each {tol} (bf16 card, int8 cross-K/V and cache, vs f32 CPU)")
        if not finite or not shapes_ok or max(errs.values()) > tol:
            raise AssertionError(f"{phase}: card vs CPU reference: finite {finite}, "
                                 f"shapes {shapes_ok}, {errs}")
        del ref, ref_tr, xa_ref, amap_ref, beam_ref

    # Every decode-attention launch's (rows, queries, positions, causal),
    # through a hook on the kernel's launch.
    shapes: Counter = Counter()

    def recording_launch(args):
        shapes[(args[8], args[11], args[13], args[15])] += 1

    def counted(fn):
        for k in kernels:
            k.launches = 0
        shapes.clear()
        unhook = _hook_decode(recording_launch)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            unhook()
        return wall, out, {k.name: k.launches for k in kernels}, Counter(shapes)

    def serve():
        return tr.transcribe_many(audios, prompts=prompts)

    runs = [counted(serve)]
    if trace:
        box = []
        wall2, _, _, _ = counted(lambda: box.append(_profiled(serve)))
        results2, by_name = box[0]
        # index_select runs as PyTorch's vectorized_gather_kernel on the card.
        families = {"beam cache reorder (index_select)": "vectorized_gather_kernel",
                    "beam top-k (topk, sort)": "[Tt]op[Kk]|[Ss]ort|[Rr]adix",
                    "scans (cumsum)": "[Ss]can"}
        _emit_profile(phase, [runs[0][:2], (wall2, results2)], by_name, card, by_family={
            label: round(sum(v for k, v in by_name.items() if re.search(pat, k)), 3)
            for label, pat in families.items()})
    else:
        wall2, results2, _, _ = counted(serve)
    wall, results, launches, seen = runs[0]

    def words(rs):
        return [[(s.tokens, [(w.word, w.start, w.end, w.probability) for w in s.words or []])
                 for s in r.segments] for r in rs]

    if words(results) != words(results2):
        raise AssertionError(f"{phase}: second run gave other tokens or word timings")
    n_words = sum(len(w) for r in words(results) for _, w in r)
    if n_words == 0 or any(r.language_probability is None for r in results):
        raise AssertionError(f"{phase}: {n_words} words; languages "
                             f"{[(r.language, r.language_probability) for r in results]}")

    # The launch arithmetic: per layer, one detection step (self, bf16 cross),
    # per decode batch a prefill (self at B*K rows; cross folded, K x P
    # queries of the B untiled rows, one launch at any P), then per step one
    # self read at B*K rows and one folded cross read of K queries at B rows.
    # Reads of more than one query run the tensor-core route, the others the
    # FMA route.
    b, rows = BATCH, BATCH * beams
    n_win = [len(chunk_audio(a, tr.chunk_samples, tr.stride_samples)[1]) for a in audios]
    batches = {p: -(-sum(n for n, q in zip(n_win, prompts) if (q is None) == (p == 3)) // b)
               for p in (3, 224)}
    steps = seen[(b, beams, 1536, 0)] // layers
    want = Counter({(b, 1, 1500, 0): layers, (b, 1, 128, 1): layers,
                    (rows, 3, 512, 1): layers * batches[3],
                    (b, 3 * beams, 1536, 0): layers * batches[3],
                    (rows, 224, 512, 1): layers * batches[224],
                    (b, 224 * beams, 1536, 0): layers * batches[224],
                    (rows, 1, 512, 1): layers * steps, (b, beams, 1536, 0): layers * steps})
    cross_rows = sorted({k[0] for k in seen if k[2] == 1536})
    routes = (launches[da.KERNEL.name], launches[da.KERNEL_MQ.name])
    if seen != want or cross_rows != [b] or routes != (
            sum(n for k, n in want.items() if k[1] == 1),
            sum(n for k, n in want.items() if k[1] > 1)):
        raise AssertionError(f"{phase}: decode-attention launches {dict(seen)} "
                             f"(FMA, tensor-core routes {routes}), expected {dict(want)}")
    idle = _never_launched(launches, skip=(W8A8.name,))
    if idle or launches[W8A8.name]:
        raise AssertionError(f"{phase}: kernels never launched: {idle}; w8a8 "
                             f"{launches[W8A8.name]} launches")

    # Previous-text conditioning on the 75 s request: window by window,
    # greedy. The initial prompt alone fills the context budget, so every
    # window's prompt is the 224-token <|startofprev|> context of the
    # initial prompt and the history.
    seq = Transcriber(model, token_table=table, batch_size=BATCH,
                      condition_on_previous_text=True, initial_prompt=prompts[2],
                      **options, **serving)
    c_wall, c_result, c_launches, c_seen = counted(lambda: seq.transcribe(audios[2]))
    c_tokens = [t for s in c_result.segments for t in s.tokens]
    prompted = c_seen[(1, 224, 512, 1)]
    if not c_tokens or prompted != layers * n_win[2] \
            or c_seen[(1, 224, 1536, 0)] != prompted:
        raise AssertionError(f"{phase}: conditioning gave {len(c_tokens)} tokens, "
                             f"decode launches {dict(c_seen)}")

    toks = [[t for s in r.segments for t in s.tokens] for r in results]
    n_tok = sum(len(t) for t in toks)
    emit(phase, model="whisper-small", options=dict(options, beams=beams, prompts=[
        None if q is None else "224-token prompt" for q in prompts]), batch=BATCH,
        requests=list(seconds), windows=sum(n_win), wall_s=wall, wall_s_second_run=wall2,
        audio_s_per_s=sum(seconds) / wall, segment_tokens=n_tok, tokens_per_s=n_tok / wall,
        words=n_words, languages=[(r.language, r.language_probability) for r in results],
        decode_steps=steps, batch_tokens_per_s=b * steps / wall,
        decode_launches_by_shape={f"B{k[0]} S{k[1]} T{k[2]}{' causal' if k[3] else ''}": n
                                  for k, n in sorted(seen.items())},
        cross_read_rows=cross_rows, launches=launches,
        conditioning=dict(wall_s=c_wall, audio_s_per_s=seconds[2] / c_wall,
                          segment_tokens=len(c_tokens),
                          windows_with_224_token_prompt=prompted // layers,
                          launches=c_launches), card=card)
    return {k: launches[k] + c_launches[k] for k in launches}


def e2e_files(card: str, kernels) -> dict:
    """Phase e2e-files: whisper-small served from audio files with the VAD
    and the silence-hallucination filter; returns the launches of its first
    call."""
    import tempfile
    import wave

    import numpy as np
    import torch

    from yoho_tpu_torch import native
    from yoho_tpu_torch.audio.flac import encode_flac
    from yoho_tpu_torch.audio.io import load_audio_f32, resample
    from yoho_tpu_torch.audio.vad import collapse_silence
    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    phase, sr = "e2e-files", 16000
    cfg = WHISPER_PRESETS["small"]
    model = init_random(Whisper(cfg, dtype=torch.bfloat16), seed=SEED)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    audios = _requests()
    # 20 s of digital silence in the middle of the 75 s request.
    gap = (int(27.5 * sr), int(47.5 * sr))
    audios[2][gap[0]:gap[1]] = 0.0

    def pcm16(x):
        return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)

    def write_wav(path, pcm, rate, channels):
        with wave.open(str(path), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(pcm.tobytes())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        stereo = pcm16(resample(audios[0], sr, 44100))
        write_wav(tmp / "a.wav", np.repeat(stereo, 2), 44100, 2)  # interleaved L, R
        flac_pcm = pcm16(audios[1])
        (tmp / "b.flac").write_bytes(encode_flac(flac_pcm.astype(np.int64)[:, None], sr))
        mono = pcm16(audios[2])
        write_wav(tmp / "c.wav", mono, sr, 1)
        paths = [tmp / "a.wav", tmp / "b.flac", tmp / "c.wav"]

        # The decoded samples against the port's resample of the same array,
        # within one int16 step.
        step = 1.0 / 32768.0
        decoded = [load_audio_f32(pth, sr) for pth in paths]
        expect = [resample(stereo.astype(np.float32) / 32768.0, 44100, sr),
                  flac_pcm.astype(np.float32) / 32768.0, mono.astype(np.float32) / 32768.0]
        decode_err = [float(np.abs(d - e).max()) for d, e in zip(decoded, expect)]
        if any(len(d) != len(e) for d, e in zip(decoded, expect)) or max(decode_err) > step:
            raise AssertionError(f"{phase}: decoded samples off the resampled arrays by "
                                 f"{decode_err} (one int16 step {step})")
        # The VAD leaves the silent stretch out (its 300 ms pads aside).
        _, smap = collapse_silence(decoded[2], sr)
        inner = (gap[0] + int(0.4 * sr), gap[1] - int(0.4 * sr))
        kept = [(o, o + n) for _c, o, n in smap.chunks]
        if any(a < inner[1] and b > inner[0] for a, b in kept):
            raise AssertionError(f"{phase}: the speech map {kept} keeps the silence {gap}")

        tr = Transcriber(model, token_table=table, batch_size=BATCH,
                         quantized_cross_kv="int8", quantized_cache=True,
                         cache_dtype=torch.bfloat16, vad_filter=True,
                         hallucination_silence_threshold=2.0)
        runs = []
        for _ in range(2):
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = tr.transcribe_many([str(pth) for pth in paths])
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, results,
                         {k.name: k.launches for k in kernels}))
    (wall, results, launches), (wall2, results2, _) = runs
    toks = [[t for s in r.segments for t in s.tokens] for r in results]
    if toks != [[t for s in r.segments for t in s.tokens] for r in results2]:
        raise AssertionError(f"{phase}: second call gave other tokens")
    seconds = [len(d) / sr for d in decoded]
    outside = [(i, s.start, s.end) for i, r in enumerate(results) for s in r.segments
               if not 0 <= s.start <= s.end <= seconds[i] + 1e-3]
    idle = _never_launched(launches, skip=(W8A8.name,))
    if outside or idle or not any(toks):
        raise AssertionError(f"{phase}: segments outside their request {outside[:4]}; "
                             f"kernels never launched {idle}; tokens {sum(map(len, toks))}")

    def windows(xs):
        return sum(len(chunk_audio(x, tr.chunk_samples, tr.stride_samples)[1]) for x in xs)

    n_tok = sum(len(t) for t in toks)
    emit(phase, model="whisper-small", batch=BATCH,
         files=["12 s stereo int16 WAV 44.1 kHz", "30 s 16-bit FLAC",
                "75 s mono int16 WAV 16 kHz, 20 s of zeros in the middle"],
         flac_decoder="native" if native.get_lib() is not None else "python",
         decode_err_vs_resample=decode_err,
         windows_without_vad=windows(decoded),
         windows_with_vad=windows([collapse_silence(d, sr)[0] for d in decoded]),
         speech_seconds=[round(collapse_silence(d, sr)[1].speech_seconds, 3) for d in decoded],
         wall_s=wall, wall_s_second_call=wall2, audio_s_per_s=sum(seconds) / wall,
         segment_tokens=n_tok, launches=launches, card=card)
    return launches


def _window_key(window) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(window, np.float32).tobytes()).hexdigest()


def _tie_check(phase: str, label: str, rows, ref) -> dict:
    """Each decoded row's tokens equal the greedy reference row of the
    same window up to their first difference, and differ there only inside
    a tie: a top-2 margin of greedy's processed logits of at most 4 bf16
    ulps of the larger logit. ``rows``: [(key, tokens)]; ``ref``: {key:
    (greedy tokens, greedy top-2 per position)}, the key a window's hash or
    a row index. Returns the rows checked, those that diverged and the
    largest margin there, in ulps."""
    import numpy as np

    diverged, worst = 0, 0.0
    for key, tok in rows:
        if key not in ref:
            raise AssertionError(f"{phase} ({label}): a decoded row has no reference row")
        g_tok, g_top2 = ref[key]
        n = min(len(tok), len(g_tok))
        diff = np.flatnonzero(np.asarray(tok[:n]) != np.asarray(g_tok[:n]))
        if len(diff) == 0:
            continue
        diverged += 1
        i = int(diff[0])
        first, second = (float(x) for x in g_top2[i])
        ulp = 2.0 ** (np.floor(np.log2(abs(first))) - 7)  # bf16: 8 significant bits
        worst = max(worst, (first - second) / ulp)
        if first - second > 4 * ulp:
            raise AssertionError(f"{phase} ({label}): row {key} leaves greedy at {i} with a "
                                 f"top-2 margin of {first - second} "
                                 f"({(first - second) / ulp} bf16 ulps of {first})")
    return dict(rows_checked=len(rows), rows_diverging=diverged,
                largest_margin_at_divergence_bf16_ulps=worst)


def e2e_spec(card: str, kernels) -> dict:
    """Phase e2e-spec: whisper-small decoding speculatively with two drafts
    (whisper-tiny with random weights: low acceptance; the target itself:
    full acceptance but at ties); returns the launches of its runs."""
    from collections import Counter

    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    phase, gamma = "e2e-spec", SPEC_GAMMA
    cfg = WHISPER_PRESETS["small"]
    model = init_random(Whisper(cfg, dtype=torch.bfloat16), seed=SEED)
    tiny = init_random(Whisper(WHISPER_PRESETS["tiny"], dtype=torch.bfloat16), seed=1)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    audios = _requests()
    serving = dict(token_table=table, batch_size=BATCH, quantized_cross_kv="int8",
                   quantized_cache=True, cache_dtype=torch.bfloat16)
    seconds = sum(len(a) for a in audios) / 16000

    # Reference on one window: a verify step of gamma + 1 queries after the
    # prompt's prefill, card (bf16, int8 cross-K/V and cache) against the
    # CPU plain path in float32 with the same weights.
    tol = 5e-2
    with torch.inference_mode():
        window = np.zeros((1, cfg.n_samples), np.float32)
        window[0, :len(audios[0])] = audios[0][:cfg.n_samples]
        mel = fused_whisper_log_mel(torch.as_tensor(window, device="cuda"), cfg.n_mels)
        ref = Whisper(cfg, dtype=torch.float32, device="cpu")
        ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        prompt = torch.as_tensor([table.sot_sequence("en")])
        # The last prompt token again, then 4 proposals.
        block = torch.as_tensor([[int(prompt[0, -1]), 1000, 2000, 3000, 4000]])

        def verify(m, ckv, caches, dev):
            m.decode_step(prompt.to(dev), caches, ckv, 0)
            return m.decode_step(block.to(dev), caches, ckv, prompt.shape[1] - 1)[0]

        got = verify(model, model.cross_kvs(model.encode_audio(mel), "int8"),
                     model.init_caches(1, torch.bfloat16, cfg.n_text_ctx + gamma + 2, True),
                     "cuda")
        want = verify(ref, ref.cross_kvs(ref.encode_audio(mel.cpu())),
                      ref.init_caches(1, None, cfg.n_text_ctx + gamma + 2), "cpu")
        rel = _rel_err(got, want)
        emit("reference", path=phase, window=1, verify_step_logits_rel_err=rel,
             tolerance=f"{tol} (bf16 card, int8 cross-K/V and cache, vs f32 CPU)")
        if not bool(torch.isfinite(got).all()) or got.shape != (1, gamma + 1, cfg.n_vocab) \
                or rel > tol:
            raise AssertionError(f"{phase}: verify logits {tuple(got.shape)}, rel err {rel}")
        del ref, want

    # Every decode-attention launch's (rows, heads, queries, positions,
    # causal), through a hook on the kernel's launch.
    shapes: Counter = Counter()

    def recording_launch(args):
        shapes[(args[8], args[9], args[11], args[13], args[15])] += 1

    def serve(tr):
        """One transcribe_many with its decode rows captured: (wall, rows
        of (tokens, length), launches, read shapes)."""
        rows = []
        decode = tr._decode_with_fallback

        def capturing(b, mel, prompt=None, **kw):
            out = decode(b, mel, prompt, **kw)
            rows.extend(zip(out[0], out[1]))
            return out

        for k in kernels:
            k.launches = 0
        shapes.clear()
        tr._decode_with_fallback = capturing
        unhook = _hook_decode(recording_launch)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.transcribe_many(audios)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            unhook()
            del tr._decode_with_fallback
        return wall, rows, {k.name: k.launches for k in kernels}, Counter(shapes)

    # Greedy, with the two largest of its processed logits (after the
    # suppression and the timestamp rules) recorded at every position: the
    # margin a speculative row may flip inside.
    greedy = Transcriber(model, **serving)
    greedy.max_len = SERVE_MAX_LEN
    top2 = torch.zeros((BATCH, cfg.n_text_ctx, 2), device="cuda")
    build = greedy._logits_fn

    def recording_rules(prompt_len):
        rules = build(prompt_len)

        def fn(logits, tokens, pos):
            out = rules(logits, tokens, pos)
            _put_top2(top2, out, pos)
            return out

        return fn

    greedy._logits_fn = recording_rules
    g_wall, g_rows, g_launches, _ = serve(greedy)
    if len(g_rows) != BATCH:  # the recorded logits are one batch's
        raise AssertionError(f"{phase}: {len(g_rows)} decode rows, one batch expected")
    g_top2 = top2.cpu().numpy()
    n_prompt = len(greedy._prompt_ids())

    total = dict(g_launches)
    out = {}
    draft_cfgs = {"whisper-tiny, random (seed 1)": tiny, "the target itself": model}
    for label, draft in draft_cfgs.items():
        tr = Transcriber(model, draft_model=draft, speculative_gamma=gamma, **serving)
        tr.max_len = SERVE_MAX_LEN
        tr.speculative_stats.clear()
        wall, rows, launches, seen = serve(tr)
        stats = dict(tr.speculative_stats)
        # The launch arithmetic: per batch a prefill of the prompt by both
        # models; per round, per draft layer one S = 2 step and gamma - 1
        # S = 1 steps, then per target layer one verify step of gamma + 1
        # queries; each step one self read (causal, the cache of the
        # horizon's max_len + gamma + 2 positions, rounded up to 128) and one
        # cross read (the 1536-padded int8 K/V) at 16 rows.
        cache_t = -(-(SERVE_MAX_LEN + gamma + 2) // 128) * 128
        batches, rounds = len(rows) // BATCH + (len(rows) % BATCH > 0), stats["rounds"]
        dc, lt = draft.cfg, cfg.n_text_layer
        want = Counter()
        for heads, layers, s, n in ((cfg.n_text_head, lt, n_prompt, batches),
                                    (dc.n_text_head, dc.n_text_layer, n_prompt, batches),
                                    (dc.n_text_head, dc.n_text_layer, 2, rounds),
                                    (dc.n_text_head, dc.n_text_layer, 1, rounds * (gamma - 1)),
                                    (cfg.n_text_head, lt, gamma + 1, rounds)):
            want[(BATCH, heads, s, cache_t, 1)] += layers * n
            want[(BATCH, heads, s, 1536, 0)] += layers * n
        if seen != want or _decode_launches(launches) != sum(want.values()):
            raise AssertionError(f"{phase} ({label}): decode-attention launches "
                                 f"{dict(seen)}, expected {dict(want)}")
        idle = _never_launched(launches, skip=(W8A8.name,))
        if idle or launches[W8A8.name] or stats["syncs"] != rounds:
            raise AssertionError(f"{phase} ({label}): kernels never launched {idle}, "
                                 f"w8a8 {launches[W8A8.name]}, stats {stats}")
        # Each row equals greedy up to its first difference, and differs
        # there only inside a tie.
        ties = _tie_check(phase, label, [(j, tok) for j, (tok, _n) in enumerate(rows)],
                          {j: (g_tok, g_top2[j]) for j, (g_tok, _g) in enumerate(g_rows)})
        for name, n in launches.items():
            total[name] += n
        out[label] = dict(
            wall_s=wall, audio_s_per_s=seconds / wall, rounds=rounds,
            committed_per_round=stats["committed"] / rounds, host_syncs=stats["syncs"],
            rows_diverging=ties["rows_diverging"],
            largest_margin_at_divergence_bf16_ulps=ties["largest_margin_at_divergence_bf16_ulps"],
            decode_launches_by_shape={f"B{k[0]} H{k[1]} S{k[2]} T{k[3]}"
                                      f"{' causal' if k[4] else ''}": n
                                      for k, n in sorted(seen.items())},
            launches=launches)
    windows = sum(len(chunk_audio(a, greedy.chunk_samples, greedy.stride_samples)[1])
                  for a in audios)
    emit(phase, model="whisper-small", gamma=gamma, batch=BATCH, windows=windows,
         greedy=dict(wall_s=g_wall, audio_s_per_s=seconds / g_wall), drafts=out, card=card)
    return total


def _post(url: str, path: str, body: bytes, ctype: str) -> bytes:
    """One HTTP POST to the server at ``url``; the response body."""
    import urllib.request

    req = urllib.request.Request(url + path, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def _stream_session(phase: str, url: str, audio, sr: int) -> list:
    """One ``GET /stream`` WebSocket session: ``audio`` in 1 s frames of
    little-endian float32, then ``{"op": "end"}``; the finalized segments."""
    import socket
    import struct

    import numpy as np

    from yoho_tpu_torch.utils import websocket as ws

    host, port = url.replace("http://", "").split(":")
    s = socket.create_connection((host, int(port)), timeout=600)
    s.sendall(("GET /stream HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
               "Connection: Upgrade\r\nSec-WebSocket-Key: AAAAAAAAAAAAAAAAAAAAAA==\r\n"
               "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += s.recv(4096)
    mask = b"\x01\x02\x03\x04"

    def send(payload, opcode):
        n = len(payload)
        hdr = (bytes([0x80 | opcode, 0x80 | n]) if n < 126 else
               bytes([0x80 | opcode, 0xFE]) + struct.pack(">H", n) if n < 65536 else
               bytes([0x80 | opcode, 0xFF]) + struct.pack(">Q", n))
        m = np.frombuffer(mask * (n // 4 + 1), np.uint8)[:n]
        s.sendall(hdr + mask + (np.frombuffer(payload, np.uint8) ^ m).tobytes())

    finals = []
    try:
        for i in range(0, len(audio), sr):
            send(audio[i:i + sr].astype("<f4").tobytes(), ws.OP_BINARY)
        send(b'{"op": "end"}', ws.OP_TEXT)
        rfile, wfile = s.makefile("rb"), s.makefile("wb")
        while True:
            msg = ws.read_message(rfile, wfile)
            if msg is None:
                raise AssertionError(f"{phase}: /stream closed before its final message")
            body = json.loads(msg[1])
            if "error" in body:
                raise AssertionError(f"{phase}: /stream error {body['error']}")
            if not body.get("partial"):
                finals += body["segments"]
            if body.get("final"):
                return finals
    finally:
        s.close()


def e2e_serve(card: str, kernels) -> dict:
    """Phase e2e-serve: whisper-small served continuously. (a) the slot
    engine with a fixed admission schedule; (b) the HTTP servers, slot
    engine and micro-batcher, with concurrent clients; (c) the speculative
    slots. Returns the launches of the three parts' measured runs (the
    greedy reference and the servers' warmups not counted)."""
    import io
    import socket
    import struct
    import threading
    import urllib.request
    import warnings
    import wave
    from collections import Counter, defaultdict
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from yoho_tpu_torch.cli.serve import drain, serve, warmup
    from yoho_tpu_torch.cli.serve_openai import _decode_wav_bytes
    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.infer.slot_engine import SlotEngine, _Window
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.srt import compose_srt, segments_to_subtitles
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
    from yoho_tpu_torch.utils import websocket as ws

    phase, chunk_tokens, sr = "e2e-serve", 16, 16000
    cfg = WHISPER_PRESETS["small"]
    model = init_random(Whisper(cfg, dtype=torch.bfloat16), seed=SEED)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    serving = dict(token_table=table, batch_size=BATCH, quantized_cross_kv="int8",
                   quantized_cache=True, cache_dtype=torch.bfloat16)
    audios = _requests()
    seconds = [len(a) / sr for a in audios]

    # The kernels' launches: set to 0 just before each part's measured run
    # and summed just after it.
    total = Counter()

    def zero_launches():
        for k in kernels:
            k.launches = 0

    def take_launches(label):
        got = {k.name: k.launches for k in kernels}
        idle = _never_launched(got, skip=(W8A8.name,))
        if idle or got[W8A8.name]:
            raise AssertionError(f"{phase} ({label}): kernels never launched {idle}, "
                                 f"w8a8 {got[W8A8.name]}")
        total.update(got)
        return got

    # Every decode-attention launch: whether it ran inside a chunk, its
    # rows, its queries, and its causal position (per-row, scalar, or none:
    # a cross read).
    shapes: Counter = Counter()
    in_chunk = [False]

    def recording_launch(args):
        shapes[(in_chunk[0], args[8], args[11], "per-row pos" if args[17] is not None
                else "scalar pos" if args[15] else "no pos")] += 1

    def by_shape():
        return {f"{'chunk' if k[0] else 'outside chunks'} B{k[1]} S{k[2]} {k[3]}": n
                for k, n in sorted(shapes.items(), key=str)}

    def chunk_hook(engine):
        """Runs each chunk of ``engine`` with the launch flag set and with
        PyTorch's sync debug mode raising on any host sync. A captured
        engine's first chunk runs its body twice, the warm-up (launched)
        and the capture (launches nothing): its reads are recorded as
        "first", and kept in ``engine.capture_shapes``, what each replay
        launches (a replay passes through no Python, so the hook sees
        none of it)."""
        chunk = engine._chunk

        def checked(state):
            first = engine.graph is not None and engine.graph.graph is None
            before = Counter(shapes)
            in_chunk[0] = "first" if first else True
            torch.cuda.set_sync_debug_mode("error")
            try:
                chunk(state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                in_chunk[0] = False
            if first:
                seen = Counter(shapes)
                seen.subtract(before)
                engine.capture_shapes = {(True,) + k[1:]: n // 2 for k, n in seen.items()
                                         if n}

        engine._chunk = checked

    def replayed(label, engine, chunks):
        """Checks that ``engine`` ran ``chunks`` chunks as its warm-up and
        replays of one capture, and returns the decode reads inside them
        (each replay's, the capture's, times the chunks) and the capture's
        numbers for the report."""
        g = engine.graph
        first = {k: n for k, n in shapes.items() if k[0] == "first"}
        if g is None or g.captures != 1 or any(n % 2 for n in first.values()):
            raise AssertionError(f"{phase} ({label}): not one capture: {g and g.captures}, "
                                 f"first-chunk reads {first}")
        if chunks is not None and g.replays + 1 != chunks:
            raise AssertionError(f"{phase} ({label}): {chunks} chunks, {g.replays} replays")
        inside = {k: n * (chunks or 1) for k, n in engine.capture_shapes.items()}
        return inside, dict(capture_s=g.capture_s, pool_bytes=g.pool_bytes, replays=g.replays,
                            launches_per_replay=g.launches_per_replay())

    def reap_syncs(engine):
        """Counts the host syncs PyTorch sees in each reap of ``engine``
        (sync debug mode "warn"); returns the running count."""
        reap, seen = engine.reap, [0]

        def counted():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    got = reap()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            seen[0] += sum("called a synchronizing CUDA operation" in str(w.message)
                           for w in caught)
            return got

        engine.reap = counted
        return seen

    def capture_rows(tr, rows):
        """Records (window key, tokens) of every window ``tr`` decodes in a
        batch (the padding rows of a short batch left out)."""
        features, decode = tr._features, tr._decode_with_fallback
        last = []

        def capturing_features(wins):
            last[:] = [np.asarray(wins, np.float32)]
            return features(wins)

        def capturing_decode(b, mel, prompt=None, **kw):
            res = decode(b, mel, prompt, **kw)
            rows.extend((_window_key(w), t) for w, t in zip(last[0], res[0]) if w.any())
            return res

        tr._features, tr._decode_with_fallback = capturing_features, capturing_decode

    # The greedy reference (the e2e configuration): every distinct window
    # the phase decodes in one batch of 16, with greedy's top-2 processed
    # logits at each position (the margin a row may flip inside).
    wav_30 = io.BytesIO()
    with wave.open(wav_30, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(np.round(audios[1] * 32767), -32768, 32767)
                      .astype(np.int16).tobytes())
    wav_30 = wav_30.getvalue()
    def served_tr(**kw):
        tr = Transcriber(model, **serving, **kw)
        tr.max_len = SERVE_MAX_LEN
        return tr

    greedy = served_tr()
    windows = [w for a in audios for w in chunk_audio(a, greedy.chunk_samples,
                                                      greedy.stride_samples)[0]]
    ref_windows = windows + list(chunk_audio(_decode_wav_bytes(wav_30, sr),
                                             greedy.chunk_samples, greedy.stride_samples)[0])
    top2 = torch.zeros((BATCH, cfg.n_text_ctx, 2), device=model.device)
    build = greedy._logits_fn

    def recording_rules(prompt_len):
        rules = build(prompt_len)

        def fn(logits, tokens, pos):
            out = rules(logits, tokens, pos)
            _put_top2(top2, out, pos)
            return out

        return fn

    greedy._logits_fn = recording_rules
    batch = np.zeros((BATCH, greedy.chunk_samples), np.float32)
    for j, w in enumerate(ref_windows):
        batch[j, :len(w)] = w
    g_tokens, g_lengths, _aux = greedy._decode_with_fallback(BATCH, greedy._features(batch))
    g_top2 = top2.cpu().numpy()
    ref = {_window_key(batch[j]): (g_tokens[j], g_top2[j]) for j in range(len(ref_windows))}
    prompt = np.asarray(greedy._prompt_ids(), np.int64)
    out = {}
    unhook = _hook_decode(recording_launch)
    try:
        # (a) The engine: the 5 windows of the three requests in four waves,
        # admitted before chunks 0, 1, 2 and 3 (20 windows for 16 slots: the
        # last wave waits for freed slots).
        tr = served_tr()
        engine = SlotEngine(tr, slots=BATCH, chunk_tokens=chunk_tokens)
        chunk_hook(engine)
        syncs = reap_syncs(engine)
        shapes.clear()
        waves, queue, done, chunk = (0, 1, 2, 3), [], [], 0
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        while queue or engine.busy or chunk <= waves[-1]:
            if chunk in waves:
                queue += [_Window(w, prompt) for w in windows]
            if queue and engine.free_slots:
                del queue[:engine.admit_many(queue)]
                done += engine.reap()
            if engine.busy:
                done += engine.step()
            chunk += 1
        wall = time.perf_counter() - t0
        launches = take_launches("a")
        stats = dict(engine.stats)
        if len(done) != len(waves) * len(windows) or syncs[0] != stats["reaps"]:
            raise AssertionError(f"{phase} (a): {len(done)} windows reaped, {syncs[0]} "
                                 f"host syncs seen in reaps, stats {stats}")
        inside, captured = replayed("a", engine, stats["chunks"])
        per_kind = stats["chunks"] * chunk_tokens * cfg.n_text_layer
        want = {(True, BATCH, 1, "per-row pos"): per_kind, (True, BATCH, 1, "no pos"): per_kind}
        if inside != want:
            raise AssertionError(f"{phase} (a): decode launches inside chunks {inside}, "
                                 f"expected {want}")
        ties = _tie_check(phase, "engine", [(_window_key(np.pad(w.window, (
            0, greedy.chunk_samples - len(w.window)))), w.tokens) for w in done], ref)
        out["engine"] = dict(
            wall_s=wall, audio_s_per_s=len(waves) * sum(seconds) / wall,
            windows=len(done), chunks=stats["chunks"], host_syncs_in_chunks=0,
            host_syncs_in_reaps=syncs[0], reaps=stats["reaps"],
            slot_occupancy_per_chunk=stats["occupied_slot_chunks"] / stats["chunks"],
            decode_launches=by_shape(), launches=launches, captured=captured, **ties)

        # (b) The servers: the three requests to /transcribe, the 30 s
        # request to the OpenAI endpoint as verbose_json and srt (a WAV
        # upload), and a /stream session of the 75 s request in 1 s frames,
        # all at once; first through the slot engine, then the micro-batcher.
        def post(url, path, body, ctype):
            return _post(url, path, body, ctype)

        def openai(url, fmt):
            bnd = "smokeboundary"
            body = (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
                    f"filename=\"a.wav\"\r\n\r\n").encode() + wav_30 + (
                f"\r\n--{bnd}\r\nContent-Disposition: form-data; name=\"response_format\""
                f"\r\n\r\n{fmt}\r\n--{bnd}--\r\n").encode()
            return post(url, "/v1/audio/transcriptions", body,
                        f"multipart/form-data; boundary={bnd}")

        def stream(url, audio):
            return _stream_session(phase, url, audio, sr)

        def keys_of(audio):
            return [_window_key(np.pad(w, (0, greedy.chunk_samples - len(w))))
                    for w in chunk_audio(audio, greedy.chunk_samples, greedy.stride_samples)[0]]

        def same(a, b):
            n = min(len(a), len(b))
            return np.array_equal(np.asarray(a[:n]), np.asarray(b[:n]))

        # transcribe_many's responses, with the tokens of every window it
        # decoded: a response is held against them where each of its
        # windows decoded to the same tokens on the server.
        exp_rows = []
        capture_rows(greedy, exp_rows)
        expected = greedy.transcribe_many(audios)
        audio_30 = _decode_wav_bytes(wav_30, sr)
        expected_30 = greedy.transcribe_many([audio_30])[0]
        exp_rows = dict(exp_rows)
        srt_30 = compose_srt(segments_to_subtitles(expected_30.segments))
        n_requests = 3 + 2 + len(chunk_audio(audios[2], greedy.chunk_samples,
                                            greedy.stride_samples)[0])
        for continuous in (True, False):
            label = "servers, slot engine" if continuous else "servers, micro-batcher"
            tr = served_tr()
            rows = []
            if continuous:
                server = serve(tr, port=0, continuous=True, chunk_tokens=chunk_tokens)
                engine = server.batcher.engine
                chunk_hook(engine)
                reap = engine.reap

                def capturing_reap(reap=reap):
                    got = reap()
                    rows.extend((_window_key(np.pad(w.window, (0, tr.chunk_samples
                                                                - len(w.window)))), w.tokens)
                                for w in got)
                    return got

                engine.reap = capturing_reap
            else:
                server = serve(tr, port=0, continuous=False)
                capture_rows(tr, rows)
            warmup(server)
            rows.clear()
            base = dict(engine.stats) if continuous else {}  # the warmup's chunks left out
            url = f"http://127.0.0.1:{server.server_address[1]}"
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            shapes.clear()
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(6) as pool:
                futs = [pool.submit(post, url, "/transcribe", a.astype("<f4").tobytes(),
                                    "application/octet-stream") for a in audios]
                futs += [pool.submit(openai, url, f) for f in ("verbose_json", "srt")]
                futs.append(pool.submit(stream, url, audios[2]))
                results = [f.result(timeout=900) for f in futs]
            wall = time.perf_counter() - t0
            launches = take_launches(label)
            with urllib.request.urlopen(url + "/statz") as r:
                statz = json.load(r)
            with urllib.request.urlopen(url + "/metrics") as r:
                metrics = r.read().decode()
            t_drain = time.perf_counter()
            drain(server, timeout_s=30)
            t_drain = time.perf_counter() - t_drain
            if statz["requests_served"] != n_requests or \
                    f"yoho_requests_served_total {n_requests}" not in metrics:
                raise AssertionError(f"{phase} ({label}): /statz {statz}, {n_requests} "
                                     "requests expected")
            ties = _tie_check(phase, label, rows, ref)
            # Each response whose windows all decoded here to transcribe_many's
            # tokens holds transcribe_many's result: the text and each
            # segment's times and text (/transcribe), times, text and tokens
            # (verbose_json, /stream), the same srt. A response with a window
            # that left transcribe_many's tokens (inside a tie, as checked
            # above) is named on a line of its own.
            served = defaultdict(list)
            for key, tok in rows:
                served[key].append(tok)

            def timed(segs):  # /transcribe: times and text
                return [(s_["start"], s_["end"], s_["text"]) for s_ in segs]

            def toks(segs):  # /stream: its own window plan, so text and tokens
                return [(s_["text"], s_["tokens"]) for s_ in segs]

            def want_timed(r, with_tokens=False):
                return [(s_.start, s_.end, s_.text)
                        + ((list(map(int, s_.tokens)),) if with_tokens else ())
                        for s_ in r.segments]

            bodies = [json.loads(r) for r in results[:4]]
            verbose = bodies[3]
            responses = [(f"/transcribe {int(seconds[i])} s", audios[i],
                          (bodies[i]["text"], timed(bodies[i]["segments"])),
                          (expected[i].text, want_timed(expected[i]))) for i in range(3)]
            responses += [
                ("verbose_json 30 s", audio_30,
                 (verbose["text"], [(s_["start"], s_["end"], s_["text"], s_["tokens"])
                                    for s_ in verbose["segments"]]),
                 (expected_30.text, want_timed(expected_30, True))),
                ("srt 30 s", audio_30, results[4].decode(), srt_30),
                ("/stream 75 s", audios[2], toks(results[5]),
                 [(s_.text, list(map(int, s_.tokens))) for s_ in expected[2].segments])]
            checked, skipped = [], []
            for name, audio, got, want in responses:
                keys = keys_of(audio)
                if any(key not in served or key not in exp_rows for key in keys):
                    raise AssertionError(f"{phase} ({label}): {name}: a window of the "
                                         "request was not decoded")
                if not all(same(t, exp_rows[key]) for key in keys for t in served[key]):
                    skipped.append(name)
                    emit("response-check-skipped", path=phase, part=label, response=name,
                         reason="a window decoded to other tokens than transcribe_many's "
                                "(inside a tie)")
                    continue
                if got != want:
                    raise AssertionError(f"{phase} ({label}): {name} differs from "
                                         f"transcribe_many's: {got!r} against {want!r}")
                checked.append(name)
            captured = {}
            if continuous:  # the chunks replay the capture (made in the warmup)
                reads, captured = replayed(label, engine, None)
                inside = sorted(k for k in reads if k[3] != "no pos")
                if not inside or any(k[3] != "per-row pos" for k in inside) or not (
                        engine.stats["chunks"] - base["chunks"]):
                    raise AssertionError(f"{phase} ({label}): causal reads in chunks {inside}")
            out[label] = dict(wall_s=wall, audio_s_per_s=(sum(seconds) + 30 * 2 + seconds[2])
                              / wall, requests_served=statz["requests_served"],
                              drain_s=t_drain, statz=statz, **ties,
                              responses_checked=checked, responses_skipped=skipped,
                              **({"chunks": engine.stats["chunks"] - base["chunks"],
                                  "reaps": engine.stats["reaps"] - base["reaps"],
                                  "slot_occupancy_per_chunk":
                                      (engine.stats["occupied_slot_chunks"]
                                       - base["occupied_slot_chunks"])
                                      / max(engine.stats["chunks"] - base["chunks"], 1)}
                                 if continuous else {}),
                              decode_launches=by_shape(), launches=launches,
                              captured=captured)

        # (c) The speculative slots: gamma 4 with the target as its own
        # draft, the 5 windows admitted one per chunk.
        gamma = SPEC_GAMMA
        tr = served_tr(draft_model=model, speculative_gamma=gamma)
        engine = SlotEngine(tr, slots=BATCH, chunk_tokens=chunk_tokens)
        chunk_hook(engine)
        syncs = reap_syncs(engine)
        shapes.clear()
        queue, done = [_Window(w, prompt) for w in windows], []
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        while queue or engine.busy:
            if queue and engine.free_slots:
                del queue[:engine.admit_many(queue[:1])]
                done += engine.reap()
            if engine.busy:
                done += engine.step()
        wall = time.perf_counter() - t0
        launches = take_launches("c")
        stats = dict(engine.stats)
        rounds = stats["chunks"] * max(1, chunk_tokens // (gamma + 1))
        verify = shapes.get((True, BATCH, gamma + 1, "per-row pos"), 0)
        inside_scalar = [k for k in shapes if k[0] and k[3] == "scalar pos"]
        if verify != rounds * cfg.n_text_layer or inside_scalar or len(done) != len(windows) \
                or syncs[0] != stats["reaps"]:
            raise AssertionError(f"{phase} (c): verify reads {verify}, {rounds} rounds, "
                                 f"scalar causal reads in chunks {inside_scalar}, "
                                 f"{len(done)} windows, {syncs[0]} host syncs seen in "
                                 f"{stats['reaps']} reaps")
        ties = _tie_check(phase, "speculative slots", [(_window_key(np.pad(w.window, (
            0, tr.chunk_samples - len(w.window)))), w.tokens) for w in done], ref)
        out["speculative slots"] = dict(
            gamma=gamma, wall_s=wall, audio_s_per_s=sum(seconds) / wall, rounds=rounds,
            chunks=stats["chunks"], host_syncs_in_chunks=0, host_syncs_in_reaps=syncs[0],
            reaps=stats["reaps"],
            slot_occupancy_per_chunk=stats["occupied_slot_chunks"] / stats["chunks"],
            decode_launches=by_shape(), launches=launches, **ties)
    finally:
        unhook()
    emit(phase, model="whisper-small", slots=BATCH, chunk_tokens=chunk_tokens,
         requests=[int(x) for x in seconds], parts=out, launches=dict(total), card=card)
    _SERVE_WALLS.update({k: dict(wall_s=v["wall_s"], audio_s_per_s=v["audio_s_per_s"])
                         for k, v in out.items()})
    return dict(total)


# e2e-serve's walls, for e2e-mesh's served runs to print beside theirs (in
# this process: world 1).
_SERVE_WALLS: dict = {}


# English words, so the corpus's language detection says "en".
TRAIN_WORDS = ("the", "water", "house", "people", "morning", "about", "little", "would",
               "there", "could", "their", "which", "other", "after", "where", "before")


class _WordText:
    """A word-level text backend for the training corpus: word i is token
    100 + i (the corpus's words go through ``standardize_text`` unchanged)."""

    def __init__(self, words):
        self.ids = {w: 100 + i for i, w in enumerate(words)}
        self.words = {i: w for w, i in self.ids.items()}

    def encode(self, text, add_special_tokens=False):
        return [self.ids[w] for w in text.split()]

    def decode(self, ids):
        return " ".join(self.words[int(i)] for i in ids if int(i) in self.words)


def _train_corpus(root: Path, tracks: int = 4, seconds: int = 60) -> None:
    """An SRT corpus from the seed: each track ``seconds`` of low noise
    with utterances of 1-3 words, each word a 0.15-0.5 s tone of its own
    pitch, and an SRT cue per utterance."""
    import datetime as dt
    import wave

    import numpy as np

    from yoho_tpu_torch.text.srt import Subtitle, compose_srt

    sr = 16000
    (root / "transcripts").mkdir(parents=True)
    (root / "audio").mkdir()
    rng = np.random.default_rng(SEED)
    for f in range(tracks):
        audio = (rng.standard_normal(seconds * sr) * 0.003).astype(np.float32)
        subs, t = [], 0.3
        while t < seconds - 3.0:
            start, words = t, []
            for _ in range(int(rng.integers(1, 4))):
                w = int(rng.integers(len(TRAIN_WORDS)))
                dur = float(rng.uniform(0.15, 0.5))
                n = int(dur * sr)
                tone = 0.4 * np.sin(2 * np.pi * (300 + 60 * w) * np.arange(n) / sr)
                audio[int(t * sr):int(t * sr) + n] += tone.astype(np.float32)
                words.append(TRAIN_WORDS[w])
                t += dur + 0.05
            subs.append(Subtitle(len(subs) + 1, dt.timedelta(seconds=start),
                                 dt.timedelta(seconds=t), " ".join(words)))
            t += float(rng.uniform(0.3, 1.2))
        (root / "transcripts" / f"track{f}.srt").write_text(compose_srt(subs))
        pcm = np.clip(audio * 32768, -32768, 32767).astype("<i2")
        with wave.open(str(root / "audio" / f"track{f}.wav"), "wb") as w_:
            w_.setnchannels(1)
            w_.setsampwidth(2)
            w_.setframerate(sr)
            w_.writeframes(pcm.tobytes())


def _flash_grad_checks(card: str) -> list:
    """The flash ``autograd.Function`` on the card in bf16: the forward (the
    kernel) against the plain version, and dq, dk, dv (the recompute)
    against ``torch.autograd.grad`` through the plain version in f32 on the
    same inputs, at the encoder's, the decoder's causal and the cross
    shapes of whisper-small at batch 8; with the backward's ms per call and
    memory above its inputs, the forward's ms, and SDPA's forward +
    backward ms (CUDA events)."""
    import torch

    from yoho_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    scale = 64 ** -0.5
    out = []
    for label, s, t, causal in (("encoder 8x1500x12x64", 1500, 1500, False),
                                ("decoder causal 8x448x12x64", 448, 448, True),
                                ("cross 8x448x1500x12x64", 448, 1500, False)):
        q = torch.randn((8, s, 12, 64), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((8, t, 12, 64), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        g = torch.randn((8, s, 12, 64), generator=gen, device=dev).to(torch.bfloat16)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = fa.KERNEL.launches
        got = fa.flash_attention(*leaves, causal=causal, scale=scale)
        if fa.KERNEL.launches != before + 1:
            raise AssertionError(f"flash gradient {label}: the forward did not launch the kernel")
        fwd_err = check_close(f"flash forward {label}", got.detach(),
                              fa.attention_reference(q, k, v, causal, scale), 1e-2, 1e-2)
        grads = torch.autograd.grad(got, leaves, g)
        ref_leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
        ref = torch.autograd.grad(fa.attention_reference(*ref_leaves, causal, scale),
                                  ref_leaves, g.float())
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
            a, b = a.float(), b.float()
            err, top = float((a - b).abs().max()), float(b.abs().max())
            # bf16 operands and a bf16 recompute against f32: 2% of the
            # largest gradient entry.
            if not torch.isfinite(a).all() or err > 0.02 * top:
                raise AssertionError(f"flash gradient {label} {name}: max abs err {err} "
                                     f"against 0.02 x max |grad| = {0.02 * top}")
            errs[name] = dict(max_abs_err=err, max_abs_grad=top)
        # The backward's cost: the plain recompute and its gradient, ms per
        # call by CUDA events around back-to-back calls (launch gaps
        # included), and the memory it holds above the inputs; the kernel's
        # forward and SDPA's forward + backward on the same inputs beside it.
        out_ = fa.flash_attention(*leaves, causal=causal, scale=scale)
        bwd_ms = event_ms(lambda: torch.autograd.grad(out_, leaves, g, retain_graph=True), 10)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.grad(out_, leaves, g, retain_graph=True)
        torch.cuda.synchronize()
        bwd_bytes = torch.cuda.max_memory_allocated() - base

        def sdpa_fwd_bwd():
            x = [t.transpose(1, 2) for t in leaves]
            o = torch.nn.functional.scaled_dot_product_attention(*x, is_causal=causal,
                                                                 scale=scale)
            return torch.autograd.grad(o, leaves, g.transpose(1, 2))

        emit("flash-grad", case=label, forward_max_abs_err=fwd_err, **errs,
             tolerance="forward rtol 1e-2, atol 1e-2; grads max abs err <= 0.02 x max |f32 grad|",
             forward_kernel_ms=event_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                                   scale=scale), 50),
             backward_recompute_ms=bwd_ms, backward_peak_bytes_above_inputs=bwd_bytes,
             sdpa_forward_backward_ms=event_ms(sdpa_fwd_bwd, 20), timing="CUDA events",
             card=card)
        del out_
        out.append(label)
        del q, k, v, g, leaves, got, grads, ref_leaves, ref
    torch.cuda.empty_cache()
    return out


def _flash_grad_vs_cpu(card: str, shape) -> dict:
    """The flash ``autograd.Function`` on the card in bf16 at a padded head
    dim (the kernel forward, the plain recompute backward) against
    ``torch.autograd.grad`` through the plain version on the CPU in f32 on
    the same inputs, causal and not; the tolerances of
    :func:`_flash_grad_checks`."""
    import torch

    from yoho_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for causal in (False, True):
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(4))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = fa.KERNEL.launches
        got = fa.flash_attention(*leaves, causal=causal)
        if fa.KERNEL.launches != before + 1:
            raise AssertionError(f"flash gradient D={shape[3]}: the forward did not launch")
        grads = torch.autograd.grad(got, leaves, g)
        cpu = [x.float().cpu().requires_grad_(True) for x in (q, k, v)]
        want = fa.attention_reference(*cpu, causal, shape[3] ** -0.5)
        ref = torch.autograd.grad(want, cpu, g.float().cpu())
        label = f"{'causal ' if causal else ''}{'x'.join(map(str, shape))} bf16 vs CPU f32"
        errs = dict(forward_max_abs_err=check_close(f"flash forward {label}", got.detach().cpu(),
                                                    want.detach(), 1e-2, 1e-2))
        for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
            a = a.float().cpu()
            err, top = float((a - b).abs().max()), float(b.abs().max())
            if not torch.isfinite(a).all() or err > 0.02 * top:
                raise AssertionError(f"flash gradient {label} {name}: max abs err {err} "
                                     f"against 0.02 x max |grad| = {0.02 * top}")
            errs[name] = dict(max_abs_err=err, max_abs_grad=top)
        emit("flash-grad", case=label, **errs, card=card,
             tolerance="forward rtol 1e-2, atol 1e-2; grads max abs err <= 0.02 x max |f32 grad|")
        out[label] = errs
    return out


def train_phase(card: str, kernels) -> dict:
    """Phase 10: whisper-small fine-tuning on the card through
    ``WhisperFinetuner.run()`` (see the module doc). Returns the launches
    of its measured runs by kernel name."""
    import math
    import tempfile

    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.nn import lora as lora_mod
    from yoho_tpu_torch.nn.params import init_random, jax_parameters
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable
    from yoho_tpu_torch.train.distill import WhisperDistiller
    from yoho_tpu_torch.train.whisper_finetune import WhisperFinetuner

    phase = "train"
    total = {k.name: 0 for k in kernels}
    grad_cases = _flash_grad_checks(card)
    cfg = WHISPER_PRESETS["small"]
    table = WhisperTokenTable(multilingual=True, text_backend=_WordText(TRAIN_WORDS))

    def zero_launches():
        for k in kernels:
            k.launches = 0

    def take_launches():
        got = {k.name: k.launches for k in kernels}
        for name, n in got.items():
            total[name] += n
        return got

    def snapshot(model, prefix=""):
        return {k: view(t).detach().clone() for k, (t, view) in jax_parameters(model).items()
                if k.startswith(prefix)}

    def same(a, b):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    with tempfile.TemporaryDirectory(prefix="yoho_train_smoke_") as tmp:
        tmp = Path(tmp)
        _train_corpus(tmp / "corpus")
        common = dict(batch_size=8, timestamps=True, language_whitelist=["en"],
                      compute_dtype=torch.bfloat16, remat=True, seed=SEED)

        # The main run: AdamW, 2 mini-batches per update, 6 updates, warmup
        # 2, augmentation on, validation (2 greedy samples) at update 3.
        model = init_random(Whisper(cfg, torch.float32), seed=SEED)
        out = tmp / "main"
        tuner = WhisperFinetuner(cfg, model, table, tmp / "corpus", out, updates=6,
                                 warmup_updates=2, learning_rate=1e-4,
                                 accumulated_batches=2, augment=True,
                                 validation_frequency=3, validation_samples=2, **common)
        first = tuner._place(tuner.train_dataloader.get_batch(0))
        loss0 = float(tuner._val_loss(*first))
        step_ms, batch_ms = [], []
        train_step, get_batch = tuner._train_step, tuner.train_dataloader.get_prepared_batch

        def timed_step(*batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = train_step(*batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return loss

        def timed_batch():
            t0 = time.perf_counter()
            batch = get_batch()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            return batch

        tuner._train_step, tuner.train_dataloader.get_prepared_batch = timed_step, timed_batch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        zero_launches()
        t0 = time.perf_counter()
        tuner.run()
        wall = time.perf_counter() - t0
        launches = take_launches()
        peak = torch.cuda.max_memory_allocated()
        lossN = float(tuner._val_loss(*first))
        losses = tuner.update_losses
        w8a8 = kernels[-1].name  # off the path: training stays float
        idle = _never_launched(launches, skip=(w8a8,))
        if idle or launches[w8a8]:
            raise AssertionError(f"{phase}: kernels of the path never launched: {idle}; "
                                 f"w8a8 {launches[w8a8]}")
        if len(losses) != 6 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{phase}: update losses {losses}")
        if not lossN < loss0:
            raise AssertionError(f"{phase}: the first batch's loss did not fall: "
                                 f"{loss0} -> {lossN}")
        files = sorted(p.name for p in out.iterdir())
        for name in ("model.safetensors", "config.json", "metrics.csv", "validations.jsonl",
                     "finetune_checkpoint.msgpack"):
            if name not in files:
                raise AssertionError(f"{phase}: {name} missing from {files}")

        # Resume: a fresh finetuner on the same out dir restores the last
        # checkpoint; its parameters equal the trained ones bit for bit.
        trained = snapshot(tuner.model)
        resumed = WhisperFinetuner(cfg, init_random(Whisper(cfg, torch.float32), seed=SEED + 1),
                                   table, tmp / "corpus", out, updates=6, warmup_updates=2,
                                   learning_rate=1e-4, accumulated_batches=2, augment=True,
                                   **common)
        if resumed.step != 12 or not same(snapshot(resumed.model), trained):
            raise AssertionError(f"{phase}: resume: step {resumed.step}, parameters equal: "
                                 f"{same(snapshot(resumed.model), trained)}")
        resumed.train_dataloader.terminate()
        resumed.val_dataloader.terminate()
        del resumed
        emit(phase, run="main", model="whisper-small", batch=8, accumulated_batches=2,
             updates=6, optimizer="adamw", remat=True, compute_dtype="bfloat16",
             update_losses=losses, first_batch_loss=[loss0, lossN],
             step_ms=step_ms, step_ms_median_after_first=float(np.median(step_ms[1:])),
             batch_ms_median=float(np.median(batch_ms)),
             audio_s_per_s=8 * 30.0 * len(step_ms) / (sum(step_ms) / 1e3),
             audio_s_per_s_at_median_step=8 * 30.0 / (float(np.median(step_ms[1:])) / 1e3),
             wall_s=wall, max_memory_allocated_bytes=peak,
             allocated_at_start_bytes=start_bytes, launches=launches,
             resumed_bit_identical=True, files=files, card=card)

        # Short runs, 2 updates each: freeze-encoder, LoRA rank 8, Adafactor.
        short = dict(common, updates=2, warmup_updates=1, learning_rate=1e-4,
                     accumulated_batches=1, augment=False, validation_frequency=0)
        results = {}
        for label, opts in (("freeze_encoder", dict(freeze_encoder=True)),
                            ("lora_rank_8", dict(lora_rank=8)),
                            ("adafactor", dict(optimizer="adafactor"))):
            m = init_random(Whisper(cfg, torch.float32), seed=SEED)
            before = snapshot(m, "encoder/" if label == "freeze_encoder" else "")
            tn = WhisperFinetuner(cfg, m, table, tmp / "corpus", tmp / label, **short, **opts)
            zero_launches()
            t0 = time.perf_counter()
            tn.run()
            wall = time.perf_counter() - t0
            got = take_launches()
            if label == "lora_rank_8":
                adapters = lora_mod.adapters_of(m)
                lora_mod.detach_lora(m)  # back to the base weights, unmerged
                if not (tmp / label / lora_mod.ADAPTER_FILE).exists():
                    raise AssertionError(f"{phase} ({label}): no adapter file")
                moved = any(bool((ab["b"] != 0).any()) for ab in adapters.values())
            else:
                moved = None
            after = snapshot(m, "encoder/" if label == "freeze_encoder" else "")
            if not same(before, after) and label != "adafactor":
                raise AssertionError(f"{phase} ({label}): frozen parameters changed")
            if label == "adafactor" and same(before, after):
                raise AssertionError(f"{phase} ({label}): no parameter moved")
            if not all(math.isfinite(x) for x in tn.update_losses):
                raise AssertionError(f"{phase} ({label}): losses {tn.update_losses}")
            results[label] = dict(update_losses=tn.update_losses, wall_s=wall, launches=got,
                                  frozen_bit_unchanged=label != "adafactor",
                                  adapters_trained=moved)
            del tn, m

        # Distillation: the trained whisper-small teaches a random whisper-tiny.
        tiny = WHISPER_PRESETS["tiny"]
        student = init_random(Whisper(tiny, torch.float32), seed=SEED + 2)
        dist = WhisperDistiller(cfg, tuner.model, tiny, student, table, tmp / "corpus",
                                tmp / "distill", **dict(short, validation_frequency=2,
                                                        validation_samples=1))
        zero_launches()
        t0 = time.perf_counter()
        dist.run()
        wall = time.perf_counter() - t0
        got = take_launches()
        if not all(math.isfinite(x) for x in dist.update_losses) or \
                dist.last_agreement is None or \
                not (tmp / "distill" / "model.safetensors").exists():
            raise AssertionError(f"{phase} (distill): losses {dist.update_losses}, agreement "
                                 f"{dist.last_agreement}")
        results["distill_small_to_tiny"] = dict(update_losses=dist.update_losses, wall_s=wall,
                                                agreement=dist.last_agreement, launches=got)
        emit(phase, run="short", runs=results, flash_grad_cases=grad_cases, card=card)
        del dist, tuner, model, student
    torch.cuda.empty_cache()
    return total


def _write_gpt2_bpe(d: Path, n_vocab: int = 50257) -> None:
    """A GPT-2 ``vocab.json`` + ``merges.txt`` built here: the 256 byte
    symbols of ``bytes_to_unicode``, then one merge per pair of symbols in
    order until the vocabulary holds ``n_vocab`` tokens (every text id of a
    whisper vocabulary renders as two bytes)."""
    from yoho_tpu_torch.text.gpt2_bpe import bytes_to_unicode

    sym = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(sym)}
    merges = []
    for a in sym:
        for b in sym:
            if len(vocab) == n_vocab:
                break
            vocab[a + b] = len(vocab)
            merges.append(f"{a} {b}")
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n",
                                  encoding="utf-8")


def _wav16(path: Path, audio) -> str:
    import wave

    import numpy as np

    pcm = np.clip(np.round(audio * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return str(path)


def _cli(argv) -> str:
    """One ``yoho-torch`` command in this process; its standard output."""
    import contextlib
    import io

    from yoho_tpu_torch.cli.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"e2e-cli: {argv[0]} exited {rc}: {out.getvalue()[-500:]}")
    return out.getvalue()


class _Recorder:
    """Records the tokens of every ``Transcriber.transcribe_many`` call
    (the commands build their transcriber inside; this is how the phase
    sees what it decoded) and times ``load_whisper_model``."""

    def __init__(self):
        from yoho_tpu_torch.cli import transcribe as cli_t
        from yoho_tpu_torch.infer.pipeline import Transcriber

        self.calls, self.load_s = [], []
        self._saved = (Transcriber.transcribe_many, cli_t.load_whisper_model)
        many, load = self._saved

        def transcribe_many(t, *a, **k):
            results = many(t, *a, **k)
            self.calls.append([[int(x) for s in r.segments for x in s.tokens]
                               for r in results])
            return results

        def load_whisper_model(*a, **k):
            import torch

            t0 = time.perf_counter()
            out = load(*a, **k)
            torch.cuda.synchronize()
            self.load_s.append(time.perf_counter() - t0)
            return out

        Transcriber.transcribe_many = transcribe_many
        cli_t.load_whisper_model = load_whisper_model

    def close(self):
        from yoho_tpu_torch.cli import transcribe as cli_t
        from yoho_tpu_torch.infer.pipeline import Transcriber

        Transcriber.transcribe_many, cli_t.load_whisper_model = self._saved


def _stream_bytes_on_card(model, cfg, batches=(16, 32), steps: int = 8,
                          beams: int = 0) -> dict:
    """``max_memory_allocated`` above the weights through the log-mel,
    encode, int8 cross-K/V, a 3-token prefill and ``steps`` decode steps on
    an int8 cache, at each batch; the slope is the measured bytes per
    stream. With ``beams`` each stream holds that many caches and decodes
    that many rows against its one cross K/V (beam search's fold)."""
    import torch

    from yoho_tpu_torch.ops.mel_kernel import fused_whisper_log_mel

    peaks = {}
    for b in batches:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            g = torch.Generator(device="cuda").manual_seed(SEED)
            audio = 0.1 * torch.randn(b, cfg.n_samples, device="cuda", generator=g)
            mel = fused_whisper_log_mel(audio, n_mels=cfg.n_mels)
            del audio  # Transcriber._features frees its window batch too
            xa = model.encode_audio(mel)
            ckv = model.cross_kvs(xa, True)
            caches = model.init_caches(b * max(1, beams), torch.bfloat16, None, True)
            tok = torch.full((b * max(1, beams), 3), 50258, dtype=torch.long, device="cuda")
            logits, caches = model.decode_step(tok, caches, ckv, 0)
            for i in range(steps):
                tok = logits[:, -1:].argmax(-1)
                logits, caches = model.decode_step(tok, caches, ckv, 3 + i)
            torch.cuda.synchronize()
            del mel, xa, ckv, caches, logits, tok
        peaks[b] = torch.cuda.max_memory_allocated() - base
    lo, hi = batches
    return dict(peak_bytes=peaks, per_stream=(peaks[hi] - peaks[lo]) / (hi - lo))


def _capacity_checks(card: str) -> dict:
    """The capacity model against the card: predicted bytes per stream at
    or above the measured slope for whisper-small (bf16, int8 K/V and cache)
    and large-v3-turbo int8, and the ``auto`` batch each resolves to."""
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer import capacity
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.quantize import quantize_whisper_decoder, quantize_whisper_encoder
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    out = {}
    for name, preset, int8 in (("whisper-small", "small", False),
                               ("large-v3-turbo", "large-v3-turbo", False),
                               ("large-v3-turbo-int8", "large-v3-turbo", True)):
        cfg = WHISPER_PRESETS[preset]
        model = init_random(Whisper(cfg, dtype=torch.bfloat16, fast_gelu=int8), seed=SEED)
        if int8:
            quantize_whisper_decoder(quantize_whisper_encoder(model))
        measured = _stream_bytes_on_card(model, cfg)
        terms = capacity.stream_terms(cfg, cross_kv="int8", cache_quantized=True,
                                      act_itemsize=2)
        predicted = sum(terms.values())
        # The staging the reading leaves room for, in (n_audio_ctx x
        # n_audio_state) bf16 tensors: what calibrates capacity._STAGING_CELLS.
        cell = cfg.n_audio_ctx * cfg.n_audio_state * 2
        needed = (measured["per_stream"] - predicted + terms["staging"]) / cell
        t = Transcriber(model, token_table=WhisperTokenTable(multilingual=True, v3=int8),
                        batch_size="auto", quantized_cross_kv=True, quantized_cache=True,
                        cache_dtype=torch.bfloat16)
        out[name] = dict(predicted_bytes_per_stream=predicted, predicted_terms=terms,
                         measured_bytes_per_stream=measured["per_stream"],
                         measured_peak_bytes_above_weights=measured["peak_bytes"],
                         staging_cells_measured=needed,
                         weight_bytes=capacity.module_bytes(model),
                         device_bytes=capacity.device_memory_bytes(t.device),
                         auto_batch=t.batch_size)
        del model, t
        torch.cuda.empty_cache()
    emit("capacity", card=card, models=out)
    for name, row in out.items():
        if row["predicted_bytes_per_stream"] < row["measured_bytes_per_stream"]:
            raise AssertionError(f"e2e-cli: {name}: predicted "
                                 f"{row['predicted_bytes_per_stream']} B per stream below "
                                 f"the measured {row['measured_bytes_per_stream']}")
    return {k: v["auto_batch"] for k, v in out.items()}


def e2e_cli(card: str, kernels) -> dict:
    """Phase e2e-cli: the command lines on a whisper-small HF directory
    written by the port's exporter (seed-0 random weights, a GPT-2
    vocabulary built here). Returns the launches of the commands' runs."""
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.export import export_hf_whisper
    from yoho_tpu_torch.nn.params import init_random, load_jax_params, to_jax_params
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.text.gpt2_bpe import GPT2BPE
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    phase = "e2e-cli"
    cfg = WHISPER_PRESETS["small"]
    total = {k.name: 0 for k in kernels}
    report = {}

    def measured(label, fn, want=(), w8a8=False):
        """Runs one command with every count set to 0 just before it and
        read just after; checks the kernels the command must launch."""
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        idle = _never_launched(launches, want)
        if idle or (launches[W8A8.name] > 0) != w8a8:
            raise AssertionError(f"{phase} ({label}): launches {launches}; "
                                 f"w8a8 expected: {w8a8}")
        for n, v in launches.items():
            total[n] += v
        report[label] = dict(wall_s=time.perf_counter() - t0, launches=launches)
        return result

    path = ("mel_log_spectrogram", "flash_attention_forward", "decode_attention")
    with tempfile.TemporaryDirectory(prefix="yoho_cli_smoke_") as tmp:
        tmp = Path(tmp)
        hf = tmp / "whisper-small"
        t0 = time.perf_counter()
        params = to_jax_params(init_random(Whisper(cfg, dtype=torch.float32),
                                           seed=SEED))
        export_hf_whisper(params, cfg, hf)
        _write_gpt2_bpe(hf)
        report["checkpoint"] = dict(write_s=time.perf_counter() - t0,
                                    bytes=(hf / "model.safetensors").stat().st_size)
        files = [_wav16(tmp / f"req{s}.wav", a) for s, a in zip((12, 30, 75), _requests())]

        # The in-process reference: the same numpy params, the CLI's settings.
        table = WhisperTokenTable(multilingual=True, text_backend=GPT2BPE.from_dir(hf))
        ref_model = load_jax_params(Whisper(cfg, dtype=torch.bfloat16), params)
        del params
        ref = Transcriber(ref_model, token_table=table, batch_size=BATCH,
                          quantized_cross_kv=True, quantized_cache=True,
                          cache_dtype=torch.bfloat16)
        ref_results = ref.transcribe_many(files)
        ref_tokens = [[int(x) for s in r.segments for x in s.tokens] for r in ref_results]
        del ref, ref_model

        rec = _Recorder()
        try:
            # transcribe: the main call.
            docs = [json.loads(x) for x in measured("transcribe", lambda: _cli(
                ["transcribe", *files, "--hf", str(hf), "--batch", str(BATCH), "--int8-kv",
                 "--json"]), path).splitlines()]
            cli_tokens = rec.calls[-1]
            if cli_tokens != ref_tokens:
                raise AssertionError(f"{phase}: transcribe's tokens differ from the "
                                     "in-process Transcriber's")
            if [d["text"] for d in docs] != [r.text for r in ref_results]:
                raise AssertionError(f"{phase}: transcribe's text differs")
            report["transcribe"].update(
                load_s=rec.load_s[-1], tokens=[len(t) for t in cli_tokens],
                tokens_equal_in_process=True,
                segments=[len(d["segments"]) for d in docs])

            # The int8 lanes through the command line: w8a8 launches.
            measured("transcribe-int8", lambda: _cli(
                ["transcribe", files[0], "--hf", str(hf), "--batch", str(BATCH), "--int8-kv",
                 "--int8-weights", "--int8-encoder", "--fast-gelu", "--json"]),
                path, w8a8=True)

            # align: every word of a given transcript gets a time.
            text = "the water house people about little"
            words = json.loads(measured("align", lambda: _cli(
                ["align", files[0], "--hf", str(hf), "--text", text]),
                ("mel_log_spectrogram", "flash_attention_forward")))["words"]
            if [w["word"].strip() for w in words] != text.split() or not all(
                    np.isfinite([w["start"], w["end"]]).all() and w["start"] <= w["end"]
                    for w in words):
                raise AssertionError(f"{phase}: align gave {words}")
            report["align"]["words"] = len(words)

            # evaluate over a two-pair SRT corpus.
            corpus = tmp / "corpus"
            _train_corpus(corpus, tracks=2, seconds=12)
            ev = json.loads(measured("evaluate", lambda: _cli(
                ["evaluate", str(corpus), "--hf", str(hf), "--batch", str(BATCH),
                 "--int8-kv", "--json"]), path).splitlines()[-1])
            if ev["utterances"] != 2 or not (np.isfinite(ev["wer"]) and np.isfinite(ev["cer"])):
                raise AssertionError(f"{phase}: evaluate gave {ev}")
            report["evaluate"].update(wer=ev["wer"], cer=ev["cer"])

            # doctor: no failed check, the card named, the auto batch.
            rows = [json.loads(x) for x in _cli(["doctor", "--json", "--hf", str(hf)])
                    .splitlines()]
            failed = [r for r in rows if r["status"] == "FAIL"]
            devices = next(r for r in rows if r["check"] == "devices")
            if failed or torch.cuda.get_device_name(0) not in devices["detail"]:
                raise AssertionError(f"{phase}: doctor: failed {failed}; devices {devices}")
            capacity_row = next((r["detail"] for r in rows
                                 if r["check"] == "devices:capacity"), None)
            report["doctor"] = dict(checks={r["check"]: r["status"] for r in rows},
                                    devices=devices["detail"], capacity=capacity_row)

            # serve: main on 127.0.0.1 port 0 in a thread, one /transcribe.
            from yoho_tpu_torch.cli import serve as serve_mod

            made, real_serve = [], serve_mod.serve
            serve_mod.serve = lambda *a, **k: made.append(real_serve(*a, **k)) or made[-1]
            out = {}

            def run_server():
                import contextlib
                import io

                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    out["rc"] = serve_mod.main(["--hf", str(hf), "--port", "0", "--batch",
                                                str(BATCH), "--int8-kv"])

            def serve_one():
                th = threading.Thread(target=run_server, daemon=True)
                th.start()
                deadline = time.monotonic() + 300
                while not made:  # bound and listening: a request queues until served
                    if time.monotonic() > deadline or not th.is_alive():
                        raise AssertionError(f"{phase}: the server did not start ({out})")
                    time.sleep(0.1)
                port = made[0].server_address[1]
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/transcribe",
                    data=Path(files[1]).read_bytes(), headers={"Content-Type": "audio/wav"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    doc = json.load(r)
                made[0].shutdown()
                th.join(120)
                if th.is_alive() or out.get("rc") != 0:
                    raise AssertionError(f"{phase}: the server did not drain ({out})")
                return doc

            try:
                rec.calls.clear()
                doc = measured("serve", serve_one, path)
            finally:
                serve_mod.serve = real_serve
            if rec.calls[-1] != [ref_tokens[1]] or doc["text"] != ref_results[1].text:
                raise AssertionError(f"{phase}: /transcribe differs from transcribe's tokens")
            report["serve"]["tokens_equal_transcribe"] = True

            # finetune: 2 updates at batch 2, the export, then transcribe it.
            tuned = tmp / "tuned"
            measured("finetune", lambda: _cli(
                ["finetune", "--hf", str(hf), "--data", str(corpus), "--out", str(tuned),
                 "--batch", "2", "--updates", "2", "--warmup", "1", "--val-every", "0",
                 "--language", "en"]), ("mel_log_spectrogram", "flash_attention_forward"))
            docs = [json.loads(x) for x in measured("transcribe-tuned", lambda: _cli(
                ["transcribe", files[0], "--hf", str(tuned), "--batch", str(BATCH), "--int8-kv",
                 "--json"]), path).splitlines()]
            if len(docs) != 1 or not (tuned / "model.safetensors").is_file():
                raise AssertionError(f"{phase}: the fine-tuned export did not transcribe")

            # distill: 1 update to a random whisper-tiny student.
            measured("distill", lambda: _cli(
                ["distill", "--hf", str(hf), "--student-preset", "tiny", "--data", str(corpus),
                 "--out", str(tmp / "draft"), "--batch", "2", "--updates", "1", "--warmup", "1",
                 "--val-every", "0", "--language", "en"]),
                ("mel_log_spectrogram", "flash_attention_forward"))
            if not (tmp / "draft" / "model.safetensors").is_file():
                raise AssertionError(f"{phase}: distill wrote no export")
        finally:
            rec.close()

    report["auto_batch"] = _capacity_checks(card)
    emit(phase, model="whisper-small", batch=BATCH, card=card, launches=total, **report)
    return total


YOHO_SECONDS = (8, 25, 60)
YOHO_PATH = ("mel_log_spectrogram", "flash_attention_forward", "decode_attention")


def _yoho_requests():
    """The three requests of e2e-yoho: 8 s, 25 s and 60 s of noise."""
    import numpy as np

    rng = np.random.default_rng(SEED + 10)
    return [(0.1 * rng.standard_normal(s * 16000)).astype(np.float32) for s in YOHO_SECONDS]


def _yoho_tokenizer(vocab_size: int, max_audio_len: int):
    """A session tokenizer of exactly ``vocab_size`` ids built here: the
    3 + ``max_audio_len`` specials, the 256 bytes, then merges of byte
    pairs in order (every text id renders as two bytes)."""
    from yoho_tpu_torch.text.bpe import ByteBPE
    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer, yoho_special_tokens

    specials = yoho_special_tokens(max_audio_len)
    base = len(specials)
    pairs = [(base + a, base + b) for a in range(256) for b in range(256)]
    return YOHOTokenizer(ByteBPE(specials, pairs[: vocab_size - base - 256]))


def _write_yoho_session(root: Path, name: str, edits=()):
    """A session directory for the full-width default YOHO configuration:
    ``config.toml`` (the port's ``DEFAULT_SESSION_TOML``, with each (old,
    new) of ``edits`` replaced in it), the tokenizer and
    ``weights/asr.ckpt`` (``save_params``) of seed-0 random f32 weights,
    with two changes of scale so that the greedy decode holds segments: the
    decoder blocks take std 0.1 (from seed 1) instead of 0.02 (at 0.02 the
    residual stream is the token's own embedding and every step repeats its
    input token), and the tied embedding's timestamp rows are 1.2 times as
    large (without it no timestamp wins an argmax against 15,000 text ids,
    so no window would hold a segment). Returns (config, tokenizer)."""
    import torch

    from yoho_tpu_torch.core.config import DEFAULT_SESSION_TOML, load_session_config
    from yoho_tpu_torch.nn.params import init_random, to_jax_params
    from yoho_tpu_torch.nn.yoho import YOHOModel
    from yoho_tpu_torch.train.checkpoint import save_params

    (root / name / "weights").mkdir(parents=True)
    (root / name / "config.toml").write_text(_edited(DEFAULT_SESSION_TOML, edits))
    config = load_session_config(name, root)
    tok = _yoho_tokenizer(config.hyperparameters.tokenizer.vocab_size,
                          config.yoho.max_audio_len)
    tok.save(config.weights.tokenizer)
    model = init_random(YOHOModel(config.yoho, tok.vocab_size,
                                  config.hyperparameters.voiceprint_finetune.embedding_dim,
                                  dtype=torch.float32), seed=SEED)
    init_random(model.decoder.blocks, seed=SEED + 1, std=0.1)
    with torch.no_grad():
        model.decoder.token_embedding.weight[tok.timestamp_base:
                                             tok.timestamp_base + tok.n_timestamps] *= 1.2
    save_params(config.weights.asr, to_jax_params(model))
    return config, tok


def _edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"session TOML has no {old!r}")
        text = text.replace(old, new)
    return text


def _yoho_cpu_reference(phase: str, tr, audio) -> dict:
    """One window through the card's kernels (bf16) against the same model
    on the CPU in float32 (plain versions): the encoder output, and the
    logits of 8 greedy steps, the CPU teacher-forced on the card's tokens.
    The tokens must agree step by step until the first step where the f32
    logits' own top-2 margin is within twice that step's measured logit
    difference (a flip the numbers explain), which ends the comparison."""
    import numpy as np
    import torch

    from yoho_tpu_torch.nn.yoho import YOHOModel
    from yoho_tpu_torch.ops.mel_kernel import fused_yoho_log_mel

    model, cfg = tr.model, tr.model.cfg
    ref = YOHOModel(cfg, model.vocab_size, model.voiceprint_dim, dtype=torch.float32,
                    device="cpu")
    ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    window = np.zeros((1, cfg.n_samples), np.float32)
    window[0, : min(len(audio), cfg.n_samples)] = audio[: cfg.n_samples]
    steps = 8
    with torch.inference_mode():
        mel = fused_yoho_log_mel(torch.as_tensor(window, device="cuda"), cfg)
        xa = model.encode_audio(mel)
        ckv, caches = model.cross_kvs(xa), model.init_caches(1, torch.bfloat16)
        xa_ref = ref.encode_audio(mel.cpu())
        ckv_ref, caches_ref = ref.cross_kvs(xa_ref), ref.init_caches(1, torch.float32)
        tok = torch.full((1, 1), tr.tokenizer.sot_id, dtype=torch.long)
        rel_lg, agreed, first_diff = [], 0, None
        for i in range(steps):
            lg, _, caches = model.decode_step(tok.cuda(), caches, ckv, i)
            lg_ref, _, caches_ref = ref.decode_step(tok, caches_ref, ckv_ref, i)
            lg, lg_ref = lg[0, -1].float().cpu(), lg_ref[0, -1]
            if not torch.isfinite(lg).all():
                raise AssertionError(f"{phase}: non-finite logits on the card")
            rel_lg.append(float((lg - lg_ref).norm() / lg_ref.norm()))
            pick, pick_ref = int(lg.argmax()), int(lg_ref.argmax())
            if first_diff is None:
                if pick == pick_ref:
                    agreed += 1
                else:
                    margin = float(lg_ref[pick_ref] - lg_ref[pick])
                    allowed = 2 * float((lg - lg_ref).abs().max())
                    if margin > allowed:
                        raise AssertionError(
                            f"{phase}: step {i}: card token {pick}, CPU {pick_ref}, f32 "
                            f"margin {margin} above twice the logit difference {allowed}")
                    first_diff = dict(step=i, f32_margin=margin, allowed=allowed)
            tok = torch.tensor([[pick]])
    rel_xa = float((xa.float().cpu() - xa_ref).norm() / xa_ref.norm())
    if rel_xa > 3e-2 or max(rel_lg) > 5e-2:
        raise AssertionError(f"{phase}: card vs CPU: encoder rel err {rel_xa}, logits "
                             f"rel err {rel_lg}")
    return dict(encoder_rel_err=rel_xa, logits_rel_err=rel_lg, steps=steps,
                tokens_agreed=agreed, first_difference=first_diff,
                tolerance="encoder 3e-2, logits 5e-2 (bf16 card vs f32 CPU)")


def _yoho_stream_bytes_on_card(model, cfg, batches=(16, 32), steps: int = 8) -> dict:
    """``max_memory_allocated`` above the weights through the YOHO log-mel,
    encode, float cross K/V, the SOT prefill and ``steps`` decode steps on
    bf16 caches, at each batch; the slope is the bytes per stream."""
    import torch

    from yoho_tpu_torch.ops.mel_kernel import fused_yoho_log_mel

    peaks = {}
    for b in batches:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            g = torch.Generator(device="cuda").manual_seed(SEED)
            audio = 0.1 * torch.randn(b, cfg.n_samples, device="cuda", generator=g)
            mel = fused_yoho_log_mel(audio, cfg)
            del audio
            xa = model.encode_audio(mel)
            ckv = model.cross_kvs(xa)
            caches = model.init_caches(b, torch.bfloat16)
            tok = torch.zeros((b, 1), dtype=torch.long, device="cuda")
            for i in range(steps + 1):
                logits, _, caches = model.decode_step(tok, caches, ckv, i,
                                                      with_voiceprints=False)
                tok = logits[:, -1:].argmax(-1)
            torch.cuda.synchronize()
            del mel, xa, ckv, caches, logits, tok
        peaks[b] = torch.cuda.max_memory_allocated() - base
    lo, hi = batches
    return dict(peak_bytes=peaks, per_stream=(peaks[hi] - peaks[lo]) / (hi - lo))


def _part_counter(phase: str, kernels):
    """``(measured, total, report)`` for a phase made of parts:
    ``measured(label, fn, want)`` sets every launch count to 0 just before
    ``fn`` and reads them just after, fails unless each kernel of ``want``
    (default: the YOHO path's three) launched and w8a8 did not, adds the
    counts to ``total`` and the part's wall and launches to ``report``."""
    import torch

    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8

    total = {k.name: 0 for k in kernels}
    report = {}

    def measured(label, fn, want=YOHO_PATH):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        idle = _never_launched(launches, want)
        if idle or launches[W8A8.name]:
            raise AssertionError(f"{phase} ({label}): launches {launches}")
        for n, v in launches.items():
            total[n] += v
        report[label] = dict(wall_s=time.perf_counter() - t0, launches=launches)
        return result

    return measured, total, report


def e2e_yoho(card: str, kernels) -> dict:
    """Phase e2e-yoho: the YOHO family at the repo's default full width
    through ``load_transcriber(session=...)``, the command lines (enroll,
    transcribe --speakers, serve --session) and the trained fixture at head
    dim 16. Returns the launches of its runs."""
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from yoho_tpu_torch.infer import capacity
    from yoho_tpu_torch.infer.continuous import ContinuousBatcher
    from yoho_tpu_torch.infer.diarize import cluster_voiceprints
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.load import load_transcriber

    phase = "e2e-yoho"
    measured, total, report = _part_counter(phase, kernels)

    def tokens_of(results):
        return [[int(x) for s in r.segments for x in s.tokens] for r in results]

    audios = _yoho_requests()
    with tempfile.TemporaryDirectory(prefix="yoho_session_smoke_") as tmp:
        tmp = Path(tmp)
        root, name = tmp / "sessions", "yoho-full"
        t0 = time.perf_counter()
        config, tok = _write_yoho_session(root, name)
        report["session"] = dict(write_s=time.perf_counter() - t0, vocab=tok.vocab_size,
                                 bytes=config.weights.asr.stat().st_size)
        cfg = config.yoho
        t0 = time.perf_counter()
        tr = load_transcriber(session=name, root=str(root), batch=BATCH)
        torch.cuda.synchronize()
        report["session"]["load_s"] = time.perf_counter() - t0
        if (cfg.dims, cfg.n_audio_heads, cfg.n_mel_bands, tr.model.vocab_size,
                tr.model.voiceprint_dim) != (384, 6, 128, 16000, 256):
            raise AssertionError(f"{phase}: not the full-width default: {cfg}")
        report["reference"] = _yoho_cpu_reference(phase, tr, audios[0])

        runs = []
        for i in range(2):
            t0 = time.perf_counter()
            results = measured(f"transcribe-{i + 1}", lambda: tr.transcribe_many(audios))
            runs.append((time.perf_counter() - t0, results))
        (wall, results), (wall2, results2) = runs
        toks = tokens_of(results)
        if toks != tokens_of(results2):
            raise AssertionError(f"{phase}: the second run gave other tokens")
        # A segment whose slot would fall past the 256-token horizon carries
        # no voiceprint (the JAX package's injection walk does the same).
        segs = [s for r in results for s in r.segments]
        vps = [s.voiceprint for s in segs if s.voiceprint is not None]
        if not vps or any(v.shape != (256,) or not np.isfinite(v).all()
                          or abs(float(np.linalg.norm(v)) - 1.0) > 1e-2 for v in vps):
            raise AssertionError(f"{phase}: {len(segs)} segments, {len(vps)} voiceprints; "
                                 "not unit vectors of 256")
        labels = cluster_voiceprints(vps)
        if any(lb is None for lb in labels) or all(s.speaker is None for s in segs):
            raise AssertionError(f"{phase}: no speaker labels")
        windows = sum(len(chunk_audio(a, tr.chunk_samples, tr.stride_samples)[1])
                      for a in audios)
        launches = report["transcribe-1"]["launches"]
        batches = -(-windows // BATCH)
        steps = _decode_launches(launches) // (2 * cfg.n_text_blocks * batches)
        report["transcribe-1"].update(
            windows=windows, batches=batches, decode_steps=steps,
            audio_s_per_s=sum(YOHO_SECONDS) / wall, wall_s_second_run=wall2,
            segments=len(segs), voiceprints=len(vps),
            segment_tokens=sum(len(t) for t in toks), speakers=len(set(labels)))
        # The captured program against its eager body and the parent's
        # route on 16 windows of noise (not counted in the phase's launches).
        report["captured"] = _graph_checks(phase, "yoho-default", tr,
                                           _auto_windows(BATCH, tr.chunk_samples), kernels,
                                           cfg.n_text_blocks)

        # The weight-only int8 decoder on the 8 s request.
        t8 = load_transcriber(session=name, root=str(root), batch=BATCH, int8_weights=True)
        r8 = measured("int8-weights", lambda: t8.transcribe_many(audios[:1]))
        a, b = tokens_of(r8)[0], toks[0]
        same = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        report["int8-weights"].update(tokens=len(a), tokens_equal_bf16_prefix=same,
                                      bf16_tokens=len(b), equal=a == b)
        del t8

        # Enrollment and naming through the command lines, on WAV files.
        wavs = [_wav16(tmp / f"yoho{s}.wav", x) for s, x in zip(YOHO_SECONDS, audios)]
        npz = tmp / "speakers.npz"
        measured("enroll", lambda: _cli(["enroll", "--session", name, "--root", str(root),
                                         "--out", str(npz), f"alice={wavs[0]}",
                                         f"bob={wavs[1]}"]))
        docs = [json.loads(x) for x in measured("transcribe-speakers", lambda: _cli(
            ["transcribe", wavs[0], wavs[1], "--session", name, "--root", str(root),
             "--batch", str(BATCH), "--speakers", str(npz), "--json"])).splitlines()]
        named = sorted({s["speaker_name"] for d in docs for s in d["segments"]} - {None})
        if not named or not set(named) <= {"alice", "bob"}:
            raise AssertionError(f"{phase}: transcribe --speakers named {named}")
        report["transcribe-speakers"]["names"] = named

        # serve --session through the slot engine: one request on port 0,
        # its tokens against the library's continuous batcher.
        recorded, finalize = [], Transcriber._finalize_request

        def recording_finalize(t, *a, **k):
            res = finalize(t, *a, **k)
            recorded.append(tokens_of([res])[0])
            return res

        lib = ContinuousBatcher(tr, chunk_tokens=16)
        try:
            # The server decodes the WAV file; so does the library here.
            lib_tokens = tokens_of([measured("library-continuous",
                                             lambda: lib.submit(wavs[1]))])[0]
        finally:
            lib.close()
        from yoho_tpu_torch.cli import serve as serve_mod

        made, real_serve, out = [], serve_mod.serve, {}
        serve_mod.serve = lambda *a, **k: made.append(real_serve(*a, **k)) or made[-1]
        Transcriber._finalize_request = recording_finalize

        def run_server():
            import contextlib
            import io

            with contextlib.redirect_stdout(io.StringIO()):
                out["rc"] = serve_mod.main(["--session", name, "--root", str(root), "--port",
                                            "0", "--batch", str(BATCH), "--continuous"])

        def serve_one():
            th = threading.Thread(target=run_server, daemon=True)
            th.start()
            deadline = time.monotonic() + 300
            while not made:
                if time.monotonic() > deadline or not th.is_alive():
                    raise AssertionError(f"{phase}: the server did not start ({out})")
                time.sleep(0.1)
            port = made[0].server_address[1]
            req = urllib.request.Request(f"http://127.0.0.1:{port}/transcribe",
                                         data=Path(wavs[1]).read_bytes(),
                                         headers={"Content-Type": "audio/wav"})
            with urllib.request.urlopen(req, timeout=300) as r:
                doc = json.load(r)
            made[0].shutdown()
            th.join(120)
            if th.is_alive() or out.get("rc") != 0:
                raise AssertionError(f"{phase}: the server did not drain ({out})")
            return doc

        try:
            doc = measured("serve-session", serve_one)
        finally:
            serve_mod.serve = real_serve
            Transcriber._finalize_request = finalize
        # The warmup's window finalizes before the loop serves the request,
        # so the request is the last one finalized.
        if not recorded or recorded[-1] != lib_tokens or not doc.get("segments"):
            raise AssertionError(f"{phase}: serve --session's tokens differ from the "
                                 "library's continuous batcher")
        report["serve-session"].update(tokens=len(lib_tokens), tokens_equal_library=True,
                                       segments=len(doc["segments"]))

        # --batch auto and the capacity model at the YOHO widths.
        measured_b = _yoho_stream_bytes_on_card(tr.model, cfg)
        terms = capacity.stream_terms(cfg, "yoho", cross_kv=None, cache_quantized=False,
                                      cache_itemsize=2, act_itemsize=2)
        auto = load_transcriber(session=name, root=str(root), batch="auto")
        cell = cfg.encoder_positions * cfg.dims * 2  # the staging term's unit
        row = dict(predicted_bytes_per_stream=sum(terms.values()), predicted_terms=terms,
                   measured_bytes_per_stream=measured_b["per_stream"],
                   staging_cells_measured=(measured_b["per_stream"] - sum(terms.values())
                                           + terms["staging"]) / cell,
                   measured_peak_bytes_above_weights=measured_b["peak_bytes"],
                   weight_bytes=capacity.module_bytes(tr.model), auto_batch=auto.batch_size)
        emit("capacity", card=card, models={"yoho-default": row})
        if row["predicted_bytes_per_stream"] < row["measured_bytes_per_stream"]:
            raise AssertionError(f"{phase}: predicted {row['predicted_bytes_per_stream']} B "
                                 f"per stream below the measured "
                                 f"{row['measured_bytes_per_stream']}")
        report["auto_batch"] = auto.batch_size
        del tr, auto, lib

    # The trained fixture (head dim 16): golden.json's text on the card,
    # the tokens of the CPU port.
    fix_root = Path(__file__).resolve().parent / "tests" / "fixtures" / "sessions"
    golden = json.loads((fix_root / "tiny" / "golden.json").read_text())
    card_t = load_transcriber(session="tiny", root=str(fix_root), batch=3)
    cpu_t = load_transcriber(session="tiny", root=str(fix_root), batch=3, device="cpu")
    clips = [_tone_clip(s, card_t.model.cfg.n_samples) for s in range(3)]
    got = measured("fixture", lambda: card_t.transcribe_many(clips))
    want = cpu_t.transcribe_many(clips)
    texts = [r.text for r in got]
    if texts != [g["text"] for g in golden] or tokens_of(got) != tokens_of(want):
        raise AssertionError(f"{phase}: the fixture on the card gave {texts}; golden "
                             f"{[g['text'] for g in golden]}")
    report["fixture"].update(texts=texts, tokens_equal_cpu=True)
    emit(phase, model="yoho default (dims 384, 6 heads on 3 KV heads, 4+4 blocks, "
                      "128 mels, vocab 16000)", batch=BATCH, requests=list(YOHO_SECONDS),
         card=card, launches=total, **report)
    return total

def _yoho_windows(n: int, seed: int):
    """``n`` one-window requests (10 s of noise each): one batch of 16."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(160_000)).astype(np.float32) for _ in range(n)]


def e2e_yoho_train(card: str, kernels, trace: bool = False) -> dict:
    """Phase e2e-yoho-train: a YOHO user's first path on the card. A
    synthetic SRT corpus from the seed; ``create-session``; ``run-session
    0`` (the tokenizer); the phase's own 16,000-id tokenizer put in its
    place so that stage 1 trains the full-width default model (stage 0's
    vocabulary on this small corpus is far below 16,000); ``run-session 1
    --max-updates 2 --compute-dtype bf16`` at the default hyperparameters
    (batch 16, 16 accumulated batches: 32 mini-steps) with validation after
    each update; the exported ``weights.asr`` served by ``transcribe
    --session --rttm`` and scored by ``score-diarization`` against RTTM
    made from the corpus's SRTs. Then the same default session with 8
    experts in encoder and decoder (two mini-steps, one batch of 16 served,
    one MoE layer on the card against the CPU port in f32), and one batch
    each of seed-0 random sessions at head dims 32, 48, 96 and 128 against
    the CPU in f32 (at 48 also the flash gradient against the CPU's).
    Between the export's serving and MoE, the corpus tools and
    stages 2-4 of the same session (``_corpus_tools``,
    ``_train_stages_2_4``). With ``trace`` the third mini-step of stage 1 is traced
    (device time by kernel against the untraced steps' median). Returns the
    launches of its parts."""
    import copy
    import statistics
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import load_session_config
    from yoho_tpu_torch.eval.diarization import SpeakerTurn, compose_rttm
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.load import load_transcriber
    from yoho_tpu_torch.nn.moe import MoESwiGLU, collect_aux_losses, dropped_fraction
    from yoho_tpu_torch.ops.decode_attention import KERNEL as DECODE
    from yoho_tpu_torch.text.srt import parse_srt
    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer
    from yoho_tpu_torch.audio.io import load_audio_f32
    from yoho_tpu_torch.train.trainer import ASRTrainer

    phase = "e2e-yoho-train"
    measured, total, report = _part_counter(phase, kernels)
    train_path = ("mel_log_spectrogram", "flash_attention_forward")
    with tempfile.TemporaryDirectory(prefix="yoho_train_smoke_") as tmp:
        tmp = Path(tmp)
        corpus, root = tmp / "corpus", tmp / "sessions"
        _train_corpus(corpus, tracks=6, seconds=60)
        _cli(["create-session", "train", "--root", str(root)])
        cfg_path = root / "train" / "config.toml"
        cfg_path.write_text(_edited(cfg_path.read_text(), (
            ("'./asr_dataset/noisy'", f"'{corpus}'"),
            ("validation_frequency = 25\nvalidation_samples = 8\nspeechless_sample_ratio = 0.1\n"
             "# Gradient", "validation_frequency = 1\nvalidation_samples = 8\n"
             "speechless_sample_ratio = 0.1\n# Gradient"))))
        t0 = time.perf_counter()
        _cli(["run-session", "train", "0", "--root", str(root)])
        config = load_session_config("train", root)
        tok0 = YOHOTokenizer.load(config.weights.tokenizer)
        text = "the water house people"
        if tok0.decode(tok0.encode(text)) != text:
            raise AssertionError(f"{phase}: stage 0's tokenizer does not round-trip {text!r}")
        report["stage-0"] = dict(wall_s=time.perf_counter() - t0, vocab=tok0.vocab_size)
        cfg, hp = config.yoho, config.hyperparameters.transcribe_pretrain
        _yoho_tokenizer(config.hyperparameters.tokenizer.vocab_size,
                        cfg.max_audio_len).save(config.weights.tokenizer)

        # Stage 1 through the command line; each mini-step timed between
        # synchronizations, each validation's decode steps counted.
        step_ms, val_steps, real = [], [], (ASRTrainer._train_step, ASRTrainer._validate)
        traced = {}

        def timed_step(self, *a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if trace and len(step_ms) == 2:
                loss, traced["by_name"] = _profiled(lambda: real[0](self, *a))
            else:
                loss = real[0](self, *a)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return loss

        def counted_validate(self, update):
            before = DECODE.launches
            out = real[1](self, update)
            val_steps.append((DECODE.launches - before) // (2 * cfg.n_text_blocks))
            return out

        ASRTrainer._train_step, ASRTrainer._validate = timed_step, counted_validate
        torch.cuda.reset_peak_memory_stats()
        try:
            measured("stage-1", lambda: _cli(
                ["run-session", "train", "1", "--root", str(root), "--max-updates", "2",
                 "--compute-dtype", "bf16"]))
        finally:
            ASRTrainer._train_step, ASRTrainer._validate = real
        peak = torch.cuda.max_memory_allocated()
        rows = [line.split(",") for line in
                (config.path / "stages" / "1" / "metrics.csv").read_text().splitlines()[1:]]
        losses = [float(r[2]) for r in rows]
        mini = hp.accumulated_batches * 2
        if (len(rows) != 2 or len(step_ms) != mini or not all(np.isfinite(losses))
                or not all(r[3] for r in rows) or len(val_steps) != 2
                or not config.weights.asr.exists()):
            raise AssertionError(f"{phase}: stage 1 rows {rows}, {len(step_ms)} mini-steps, "
                                 f"validations {val_steps}")
        after_first = step_ms[1:]
        if trace:
            _emit_profile(phase, [(statistics.median(after_first) / 1e3, None),
                                  (step_ms[2] / 1e3, None)], traced["by_name"], card,
                          run="stage-1 mini-step 3 traced (untraced: the median step)")
        report["stage-1"].update(
            batch=hp.batch_size, accumulated=hp.accumulated_batches, mini_steps=len(step_ms),
            update_losses=losses, val_losses=[float(r[3]) for r in rows],
            step_ms_first=step_ms[0], step_ms_median=statistics.median(after_first),
            step_ms_range=[min(after_first), max(after_first)],
            trained_audio_s_per_s=hp.batch_size * cfg.max_input_seconds
            / (statistics.median(after_first) / 1e3),
            max_memory_allocated=peak, validation_decode_steps=val_steps,
            launches_per_mini_step={k: v / len(step_ms) for k, v in
                                    report["stage-1"]["launches"].items()})

        # The export served with --rttm over one batch of 16 windows, and
        # scored against RTTM from the corpus's SRTs.
        # Whole tracks, then a prefix of the next one, to fill 16 windows at
        # the transcriber's stride (5 s of overlap).
        stride = cfg.n_samples - min(5 * 16000, cfg.n_samples // 2)
        hyp, ref, cut = tmp / "hyp", tmp / "ref", tmp / "cut"
        ref.mkdir()
        cut.mkdir()
        chosen, windows = [], 0
        for path in sorted((corpus / "audio").glob("*.wav")):
            audio = load_audio_f32(str(path), 16000)
            n = len(chunk_audio(audio, cfg.n_samples, stride)[1])
            seconds = len(audio) // 16000
            while windows + n > BATCH and seconds > 1:
                seconds -= 1
                n = len(chunk_audio(audio[: seconds * 16000], cfg.n_samples, stride)[1])
            if windows + n > BATCH:
                break
            if seconds * 16000 < len(audio):
                path = Path(_wav16(cut / path.name, audio[: seconds * 16000]))
            subs = parse_srt((corpus / "transcripts" / f"{path.stem}.srt").read_text())
            turns = [SpeakerTurn(c.start.total_seconds(), c.end.total_seconds(), "spk")
                     for c in subs if c.end.total_seconds() <= seconds]
            (ref / f"{path.stem}.rttm").write_text(compose_rttm(turns, path.stem))
            chosen.append(str(path))
            windows += n
            if windows == BATCH:
                break
        docs = measured("transcribe-export", lambda: _cli(
            ["transcribe", *chosen, "--session", "train", "--root", str(root), "--batch",
             str(BATCH), "--rttm", str(hyp), "--json"])).splitlines()
        score = json.loads(_cli(["score-diarization", str(ref), str(hyp), "--json"])
                           .splitlines()[-1])
        if (len(docs) != len(chosen) or sorted(score["recordings"])
                != sorted(Path(p).stem for p in chosen)):
            raise AssertionError(f"{phase}: transcribe --rttm / score-diarization: {score}")
        report["transcribe-export"].update(
            files=len(chosen), windows=windows, der=score["der"],
            segments=sum(len(json.loads(d)["segments"]) for d in docs))

        # The corpus tools, then stages 2-4 on the same session.
        report["corpus-tools"] = _corpus_tools(phase, tmp, corpus, root)
        _train_stages_2_4(phase, measured, report, root, chosen, ref, tmp)

        # Mixture of experts: 8 experts in every other block of both stacks.
        _cli(["create-session", "moe", "--root", str(root)])
        moe_path = root / "moe" / "config.toml"
        moe_path.write_text(_edited(moe_path.read_text(), (
            ("n_text_blocks = 4\n", "n_text_blocks = 4\nn_experts = 8\nmoe_in_decoder = true\n"),
            ("'./asr_dataset/noisy'", f"'{corpus}'"))))
        moe_cfg = load_session_config("moe", root)
        _yoho_tokenizer(16000, cfg.max_audio_len).save(moe_cfg.weights.tokenizer)
        moe_hp = replace(moe_cfg.hyperparameters.transcribe_pretrain, accumulated_batches=1,
                         validation_frequency=1000)
        trainer = ASRTrainer(moe_cfg, hp=moe_hp, compute_dtype=torch.bfloat16)
        n_moe = sum(isinstance(m, MoESwiGLU) for m in trainer.model.modules())
        measured("moe-train", lambda: trainer.run(max_updates=2), want=train_path)
        aux = float(collect_aux_losses(trainer.model).detach())
        moe_losses = list(trainer.update_losses)
        if n_moe != 4 or not all(np.isfinite(moe_losses)) or not aux > 0:
            raise AssertionError(f"{phase}: MoE layers {n_moe}, losses {moe_losses}, "
                                 f"aux {aux}")
        mlp = trainer.model.encoder.blocks[1].mlp
        x = torch.randn((2, cfg.encoder_positions, cfg.dims), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
        with torch.no_grad():
            got = mlp(x)
            want = copy.deepcopy(mlp).cpu()(x.cpu())
        moe_err = check_close("MoE layer card vs CPU f32", got.cpu(), want, 1e-4, 1e-5)
        del trainer
        moe_t = load_transcriber(session="moe", root=str(root), batch=BATCH)
        res = measured("moe-serve", lambda: moe_t.transcribe_many(_yoho_windows(BATCH, 1)))
        report["moe-train"].update(experts=8, moe_layers=n_moe, mini_steps=2,
                                   update_losses=moe_losses)
        report["moe"] = dict(aux_loss=aux, dropped_fraction=dropped_fraction(moe_t.model),
                             layer_max_abs_err=moe_err, layer_tolerance="rtol 1e-4, atol 1e-5",
                             served=len(res))
        del moe_t

        # Head dims 32, 48, 96 and 128 at the default depth (48 and 96 run
        # padded to the kernels' widths 64 and 128): one batch each, and one
        # window against the CPU in f32.
        for d, dims, heads in ((32, 384, 12), (48, 384, 8), (96, 384, 4), (128, 512, 4)):
            name = f"d{d}"
            _write_yoho_session(root, name, (
                ("dims = 384", f"dims = {dims}"),
                ("n_audio_heads = 6", f"n_audio_heads = {heads}"),
                ("n_text_heads = 6", f"n_text_heads = {heads}")))
            t = load_transcriber(session=name, root=str(root), batch=BATCH)
            if t.model.decoder.blocks[0].attn.head_dim != d:
                raise AssertionError(f"{phase}: head dim {t.model.decoder.blocks[0].attn.head_dim}")
            reqs = _yoho_windows(BATCH, d)
            ref_d = _yoho_cpu_reference(phase, t, reqs[0])
            res = measured(f"serve-D{d}", lambda: t.transcribe_many(reqs))
            report[f"serve-D{d}"].update(dims=dims, heads=heads, kv_heads=heads // 2,
                                         windows=len(res), reference=ref_d)
            if len(res) != BATCH:
                raise AssertionError(f"{phase}: D={d} served {len(res)} windows")
            del t
            if d == 48:
                report["flash-grad-D48"] = _flash_grad_vs_cpu(card, (4, 512, 8, 48))
    emit(phase, model="yoho default (dims 384, 6 heads on 3 KV heads, 4+4 blocks, 128 mels, "
                      "vocab 16000)", card=card, launches=total, **report)
    return total


# Launches per mini-step of stages 2-4 (mel, flash attention forward): stage
# 2 the encoder's 4 blocks and the VAE decoder's 2, stage 3 the encoder's 4,
# stage 4 the student's 4 encoder + 4 causal + 4 cross and the teacher's 4
# (its encoder once per batch, every span mask pooling its output).
STAGE_LAUNCHES = {2: (1, 6), 3: (1, 4), 4: (1, 16)}


def _speaker_csv(src: Path) -> None:
    """A generic-CSV corpus for ``import-corpus --speakers``: 8 speakers x 4
    clips of 3-6 s, each speaker a voiced tone (three harmonics, a 3 Hz
    tremolo) at its own pitch in low noise, from the seed."""
    import numpy as np

    sr, rng = 16000, np.random.default_rng(SEED + 20)
    (src / "clips").mkdir(parents=True)
    rows = ["audio,transcript,speaker"]
    for s in range(8):
        f0 = 110.0 + 35.0 * s
        for c in range(4):
            t = np.arange(int(rng.uniform(3.0, 6.0) * sr)) / sr
            x = sum(0.2 / h * np.sin(2 * np.pi * h * f0 * t) for h in (1, 2, 3))
            x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) + 0.005 * rng.standard_normal(len(t))
            _wav16(src / "clips" / f"s{s}_c{c}.wav", x.astype(np.float32))
            rows.append(f"clips/s{s}_c{c}.wav,{TRAIN_WORDS[s]} {TRAIN_WORDS[c]},spk{s}")
    (src / "index.csv").write_text("\n".join(rows) + "\n")


def _corpus_tools(phase: str, tmp: Path, corpus: Path, root: Path) -> dict:
    """``import-corpus --speakers`` of a generic CSV into the session's
    ``speakers/`` layout (the session TOML pointed at it), ``cache-corpus``
    of the training corpus (the stage-2 dataloader keeps one file per stem:
    its files and batches unchanged, all FLAC), ``split-tracks`` of one 60 s
    track (every subtitle whole inside one chunk)."""
    import shutil
    import wave

    from yoho_tpu_torch.core.config import load_session_config
    from yoho_tpu_torch.text.srt import parse_srt
    from yoho_tpu_torch.train.dataloader import AudioChunkDataloader

    t0 = time.perf_counter()
    src, spk = tmp / "speaker_src", tmp / "speaker_corpus"
    _speaker_csv(src)
    _cli(["import-corpus", str(src), str(spk), "--format", "csv", "--audio-col", "audio",
          "--text-col", "transcript", "--speaker-col", "speaker", "--speakers", "--copy", "-q"])
    layout = {d.name: len(list(d.iterdir())) for d in (spk / "speakers").iterdir()}
    if layout != {f"spk{s}": 4 for s in range(8)} or \
            len(list((spk / "transcripts").iterdir())) != 32:
        raise AssertionError(f"{phase}: import-corpus speakers/ layout {layout}")
    cfg_path = root / "train" / "config.toml"
    cfg_path.write_text(_edited(cfg_path.read_text(), (
        ("'./asr_dataset/speakers'", f"'{spk / 'speakers'}'"),)))
    config = load_session_config("train", root)

    def chunks():
        dl = AudioChunkDataloader(config, config.hyperparameters.reconstruct_pretrain.batch_size,
                                  use_multiprocessing=False)
        return dl.files, dl.get_num_batches(), len(dl.chunks)

    files, batches, n_chunks = chunks()
    _cli(["cache-corpus", str(corpus), "--workers", "1"])
    files2, batches2, n_chunks2 = chunks()
    if ([p.stem for p in files2] != [p.stem for p in files] or (batches2, n_chunks2)
            != (batches, n_chunks) or any(p.suffix != ".flac" for p in files2)):
        raise AssertionError(f"{phase}: cache-corpus: {len(files)} -> {len(files2)} files, "
                             f"{batches} -> {batches2} batches")

    split_src = tmp / "split_src"
    track = sorted((corpus / "audio").glob("*.wav"))[0]
    for sub, f in (("audio", track), ("transcripts", corpus / "transcripts" / f"{track.stem}.srt")):
        (split_src / sub).mkdir(parents=True, exist_ok=True)
        shutil.copy(f, split_src / sub / f.name)
    _cli(["split-tracks", str(split_src), str(tmp / "split"), "--approx_duration", "20",
          "--workers", "1"])
    n_subs = len(list(parse_srt((split_src / "transcripts" / f"{track.stem}.srt").read_text())))
    placed, n_split = 0, 0
    for srt in sorted((tmp / "split" / "transcripts").iterdir()):
        with wave.open(str(tmp / "split" / "audio" / f"{srt.stem}.wav")) as w:
            seconds = w.getnframes() / w.getframerate()
        n_split += 1
        for c in parse_srt(srt.read_text()):
            if not 0 <= c.start.total_seconds() < c.end.total_seconds() <= seconds:
                raise AssertionError(f"{phase}: split-tracks chunk {srt.stem} ({seconds} s) "
                                     f"cuts {c}")
            placed += 1
    if placed != n_subs or n_split < 2:
        raise AssertionError(f"{phase}: split-tracks kept {placed} of {n_subs} subtitles "
                             f"in {n_split} chunks")
    return dict(wall_s=time.perf_counter() - t0, speakers=8, speaker_clips=32,
                flac_files=len(files2), stage2_batches=batches2, stage2_chunks=n_chunks2,
                split_chunks=n_split, subtitles=n_subs)


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    """A flax tree as {'/'-joined path: leaf}."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat_tree(v, p) if isinstance(v, dict) else {p: v})
    return out


def _leaves_equal(got: dict, want: dict) -> int:
    """Leaf for leaf bit-equal flax trees (numpy leaves); the leaf count."""
    import numpy as np

    got, want = _flat_tree(got), _flat_tree(want)
    bad = sorted(k for k in got
                 if k not in want or not np.array_equal(np.asarray(got[k]), np.asarray(want[k])))
    if bad or set(got) != set(want):
        raise AssertionError(f"leaves differ: {bad[:5]}, keys {sorted(set(got) ^ set(want))[:5]}")
    return len(got)


def _train_stages_2_4(phase: str, measured, report: dict, root: Path, chosen, ref: Path,
                      tmp: Path) -> None:
    """``run-session 2``, ``3`` and ``4 --max-updates 1 --compute-dtype bf16``
    of the default session ``train`` at its hyperparameters (batch 16 x 16
    accumulated: 16 mini-steps each), each mini-step timed between
    synchronizations and its launches checked against ``STAGE_LAUNCHES``;
    stage 3's encoder at its first step equal to stage 2's export, stage
    4's student at its first step equal to stage 1's export and its teacher
    bit-unchanged (stage 3's export) after the run; one stage-4 batch's CE
    and voiceprint loss on the card against the CPU port in f32; stage 4's
    export served with ``--rttm`` and scored."""
    import copy
    import statistics

    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import load_session_config
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import jax_leaves, to_jax_params
    from yoho_tpu_torch.train.checkpoint import load_params
    from yoho_tpu_torch.train.stages.stage2_reconstruction import ReconstructionTrainer
    from yoho_tpu_torch.train.stages.stage3_voiceprint import VoiceprintTrainer
    from yoho_tpu_torch.train.stages.stage4_joint_finetune import JointTrainer

    config = load_session_config("train", root)
    cfg, hps = config.yoho, config.hyperparameters
    hp_of = {2: hps.reconstruct_pretrain, 3: hps.voiceprint_finetune,
             4: hps.transcribe_finetune}
    slot_of = {2: config.weights.voice_reconstruction, 3: config.weights.voiceprint,
               4: config.weights.yoho}

    def stage(n, cls, probe):
        label, step_ms, seen = f"stage-{n}", [], {}
        real = cls._train_step

        def timed_step(self, *a):
            if not step_ms:
                seen["trainer"], seen["probe"] = self, probe(self)
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = real(self, *a)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return loss

        cls._train_step = timed_step
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        try:
            measured(label, lambda: _cli(
                ["run-session", "train", str(n), "--root", str(root), "--max-updates", "1",
                 "--compute-dtype", "bf16"]), want=("mel_log_spectrogram",
                                                    "flash_attention_forward"))
        finally:
            cls._train_step = real
        peak = torch.cuda.max_memory_allocated()
        hp = hp_of[n]
        rows = [line.split(",") for line in
                (config.path / "stages" / str(n) / "metrics.csv").read_text().splitlines()[1:]]
        losses = [float(r[2]) for r in rows]
        launches = report[label]["launches"]
        per_step = {k: v / max(len(step_ms), 1) for k, v in launches.items()}
        mel, flash = STAGE_LAUNCHES[n]
        if (len(rows) != 1 or not all(np.isfinite(losses)) or len(step_ms)
                != hp.accumulated_batches or not slot_of[n].exists()
                or (per_step["mel_log_spectrogram"], per_step["flash_attention_forward"],
                    _decode_launches(per_step)) != (mel, flash, 0)):
            raise AssertionError(f"{phase}: {label} rows {rows}, {len(step_ms)} mini-steps, "
                                 f"launches per mini-step {per_step}")
        after_first = step_ms[1:]
        report[label].update(
            batch=hp.batch_size, accumulated=hp.accumulated_batches, mini_steps=len(step_ms),
            update_losses=losses, step_ms_first=step_ms[0],
            step_ms_median=statistics.median(after_first),
            step_ms_range=[min(after_first), max(after_first)],
            trained_audio_s_per_s=hp.batch_size * cfg.max_input_seconds
            / (statistics.median(after_first) / 1e3),
            max_memory_allocated=peak, memory_held_before=held,
            launches_per_mini_step=per_step, export=slot_of[n].name)
        return seen

    stage(2, ReconstructionTrainer, lambda tr: None)
    s3 = stage(3, VoiceprintTrainer, lambda tr: _leaves_equal(
        to_jax_params(tr.model.encoder),
        load_params(config.weights.voice_reconstruction)["encoder"]))
    report["stage-3"]["warm_start_leaves_equal_stage2_encoder"] = s3["probe"]
    s4 = stage(4, JointTrainer, lambda tr: _leaves_equal(
        to_jax_params(tr.model), load_params(config.weights.asr)))
    tr = s4.pop("trainer")
    teacher = _leaves_equal(to_jax_params(tr.teacher), load_params(config.weights.voiceprint))

    # One batch's CE and voiceprint loss: the card (bf16 autocast) against a
    # float32 copy of the trained model and teacher on the CPU.
    batch = tr.train_dataloader.get_batch(0)
    with torch.no_grad():
        card_losses = [float(x) for x in tr._losses(*tr._place(batch))]
        cpu = copy.copy(tr)
        cpu.device, cpu.compute_dtype = torch.device("cpu"), torch.float32
        cpu.model, cpu.teacher = copy.deepcopy(tr.model).cpu(), copy.deepcopy(tr.teacher).cpu()
        cpu_losses = [float(x) for x in cpu._losses(*cpu._place(batch))]
    del cpu, tr
    (ce, vp), (ce_ref, vp_ref) = card_losses, cpu_losses
    if not (np.isfinite(card_losses).all() and abs(ce - ce_ref) <= 2e-2 * abs(ce_ref)
            and abs(vp - vp_ref) <= 5e-2):
        raise AssertionError(f"{phase}: stage-4 losses card {card_losses}, CPU {cpu_losses}")
    report["stage-4"].update(
        student_start_leaves_equal_stage1_export=s4["probe"],
        teacher_leaves_unchanged=teacher,
        batch_losses=dict(card_bf16=dict(ce=ce, voiceprint=vp),
                          cpu_f32=dict(ce=ce_ref, voiceprint=vp_ref),
                          tolerance="CE 2e-2 relative, voiceprint loss 5e-2 absolute "
                                    "(bf16 card vs f32 CPU)"))

    # Stage 4's export served (transcribe --session prefers weights.yoho):
    # the served weights are the export's in bf16, every segment carries a
    # unit voiceprint of 256; the RTTM scores against the SRTs' (ref).
    served, many = [], Transcriber.transcribe_many

    def recording(t, *a, **k):
        served.append(t)
        return many(t, *a, **k)

    hyp = tmp / "hyp-stage4"
    Transcriber.transcribe_many = recording
    try:
        docs = measured("transcribe-stage-4", lambda: _cli(
            ["transcribe", *chosen, "--session", "train", "--root", str(root), "--batch",
             str(BATCH), "--rttm", str(hyp), "--json"])).splitlines()
    finally:
        Transcriber.transcribe_many = many
    # Each served tensor is the export's leaf in that tensor's type (bf16
    # matrices, float32 norm scales).
    export = _flat_tree(load_params(config.weights.yoho))
    served_leaves = jax_leaves(served[0].model)
    bad = [k for k, t in served_leaves.items() if not torch.equal(
        t.detach().cpu(), torch.from_numpy(np.array(export[k])).to(t.dtype))]
    if bad or set(served_leaves) != set(export):
        raise AssertionError(f"{phase}: the served weights are not weights.yoho: {bad[:5]}")
    segments = [seg for d in docs for seg in json.loads(d)["segments"]]
    norms = [float(np.linalg.norm(seg["voiceprint"])) for seg in segments]
    if (len(docs) != len(chosen) or served[0].model.voiceprint_dim != 256
            or any(len(seg["voiceprint"]) != 256 for seg in segments)
            or not all(abs(n - 1) < 1e-2 for n in norms)):
        raise AssertionError(f"{phase}: stage-4 export served: {len(docs)} docs, norms {norms}")
    # The served voiceprint head on one window, teacher-forced from SOT at
    # every position (the random-weight run may decode no segment).
    from yoho_tpu_torch.audio.io import load_audio_f32
    from yoho_tpu_torch.ops.mel_kernel import fused_yoho_log_mel

    window = np.zeros((1, cfg.n_samples), np.float32)
    audio = load_audio_f32(chosen[0], cfg.sample_rate)[: cfg.n_samples]
    window[0, : len(audio)] = audio
    dev = served[0].model.device
    with torch.inference_mode():
        mel = fused_yoho_log_mel(torch.as_tensor(window, device=dev), cfg)
        tokens = torch.full((1, cfg.max_text_len), served[0].tokenizer.sot_id,
                            dtype=torch.long, device=dev)
        vp = served[0].model.forward_with_voiceprints(tokens, mel)[1].float()
    vp_norm = vp.norm(dim=-1)
    if vp.shape[-1] != 256 or not bool(((vp_norm - 1).abs() < 1e-2).all()):
        raise AssertionError(f"{phase}: served voiceprints {tuple(vp.shape)}, norms "
                             f"{float(vp_norm.min())}-{float(vp_norm.max())}")
    score = json.loads(_cli(["score-diarization", str(ref), str(hyp), "--json"])
                       .splitlines()[-1])
    report["transcribe-stage-4"].update(
        files=len(chosen), segments=len(segments), segment_voiceprints=len(norms),
        voiceprint_dim=int(vp.shape[-1]), teacher_forced_voiceprints=int(vp.shape[1]),
        der=score["der"])


def _tone_clip(s: int, n_samples: int):
    """The trained fixture's clips: ``tests/test_checkpoint_fixture.py``'s
    ``_tone_clip`` (a tone of 440, 880 or 1320 Hz in low noise)."""
    import numpy as np

    audio = (np.random.default_rng(9).standard_normal(n_samples) * 0.002).astype(np.float32)
    tone = 0.4 * np.sin(2 * np.pi * (440, 880, 1320)[s] * np.arange(4000) / 16000)
    audio[800:800 + len(tone)] += tone.astype(np.float32)
    return audio


# ------------------------------------------------------ captured programs

class _DecodeTimer:
    """Times each ``greedy_decode`` the decode programs call, from a device
    sync before its prefill to one after it returns: the decode alone,
    without the encoder and the cross-K/V. The sync before falls ahead of
    the prefill, outside every chunk."""

    def __enter__(self):
        from yoho_tpu_torch.infer import decode_programs

        self.module, self.real, self.seconds = decode_programs, decode_programs.greedy_decode, []

        def timed(*a, **k):
            import torch

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(*a, **k)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        self.module.greedy_decode = timed
        return self

    def __exit__(self, *exc):
        self.module.greedy_decode = self.real


def _int_pos_decode(tr, mel):
    """The parent's route on ``tr``'s settings: the same greedy steps driven
    eagerly with an int ``pos`` (scalar-position decode reads, slice cache
    writes), which ``decode_step`` still takes because beam search drives
    it so; the early-exit check every ``_SYNC_EVERY`` steps, the loop
    stopping at ``max_len``. Returns the tokens and the top-2 of the
    processed logits at each position (the tie rule's margins)."""
    import torch

    from yoho_tpu_torch.infer.decode import _SYNC_EVERY, _suppress, suppress_index

    model, length, eot = tr.model, tr.max_len, tr.eot
    p = len(tr._prompt_ids())
    rules = type(tr)._logits_fn(tr, p)
    with torch.inference_mode():
        b, dev = mel.shape[0], mel.device
        ckv = model.cross_kvs(model.encode_audio(mel), tr.quantized_cross_kv)
        caches = model.init_caches(b, tr.cache_dtype, None, tr.quantized_cache)
        step = tr._make_step(ckv)
        sup = suppress_index(tr._suppress_ids(), dev)
        tokens = torch.full((b, length), eot, dtype=torch.long, device=dev)
        tokens[:, :p] = torch.as_tensor([tr._prompt_ids()] * b, device=dev)
        top2 = torch.full((b, length, 2), float("nan"), device=dev)

        def pick(logits, pos):
            out = _suppress(logits.float(), sup)
            if rules is not None:
                out = rules(out, tokens, pos)
            _put_top2(top2, out, pos)
            return torch.argmax(out, dim=-1)

        logits, _ = step(tokens[:, :p], caches, 0)
        tokens[:, p] = pick(logits[:, -1], p)
        finished = tokens[:, p] == eot
        pos = p
        while pos + 1 < length:
            if (pos - p) % _SYNC_EVERY == 0 and bool(finished.all()):
                break
            logits, _ = step(tokens[:, pos:pos + 1], caches, pos)
            nxt = torch.where(finished, eot, pick(logits[:, -1], pos + 1))
            tokens[:, pos + 1] = nxt
            finished = finished | (nxt == eot)
            pos += 1
    return tokens.cpu().numpy(), top2.cpu().numpy()


def _timed_program(fn, mel, kernels):
    """One call of a decode program on ``mel`` with every launch count set
    to 0 just before and read just after: (result, wall s, decode s,
    launches)."""
    import torch

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _DecodeTimer() as timer:
        out = fn(mel)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, sum(timer.seconds), {k.name: k.launches
                                                                 for k in kernels}


def _same_results(a, b) -> bool:
    """Two decode programs' (tokens, lengths, aux) bit for bit."""
    import numpy as np

    return (all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2])) and a[2].keys() == b[2].keys()
            and all(np.array_equal(a[2][k], b[2][k]) for k in a[2]))


def _graph_checks(phase: str, label: str, tr, wins, kernels, n_layers: int,
                  max_len=None) -> dict:
    """The captured greedy program of ``tr`` at batch ``len(wins)`` (16),
    decoding ``max_len`` positions a window (``AUTO_MAX_LEN`` by default,
    to fit the time limit): held to the same chunk body run
    eagerly (tokens, lengths, sum_logprob and no_speech_prob bit for bit,
    launches per kernel equal) on its first call (warm-up chunk, capture,
    replays) and on a second (replays only, no capture); the first call
    under sync debug mode "warn" with every host sync between chunks; the
    parent's route (``_int_pos_decode``) left only at ties. Returns the
    line's fields: walls, decode seconds and ms per step of both routes,
    capture seconds, the graph pool's bytes, the workspace's and the bytes
    held after the call."""
    import warnings

    import numpy as np
    import torch

    b, saved = len(wins), tr.max_len
    max_len = max_len or AUTO_MAX_LEN
    tr.max_len = max_len
    try:
        p = len(tr._prompt_ids())
        tr._workspaces.pop(b, None)  # a program captured now, at this horizon
        mel = tr._features(np.stack(wins))
        eager = tr._build_decode_fn(b, 0.0, p, captured=False)
        want, e_wall, e_dec, e_launch = _timed_program(eager, mel, kernels)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                marks, undo = _watch_steps(tr, caught)
                try:
                    got, g_wall, g_dec, g_launch = _timed_program(tr._decode_fn(b), mel, kernels)
                finally:
                    undo()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        held_after = torch.cuda.memory_allocated() - held
        ws = tr._workspaces[b]
        prog = ws.graphs[(0.0, p)]
        replays_first = prog.replays
        again, a_wall, a_dec, a_launch = _timed_program(tr._decode_fn(b), mel, kernels)
        checks, capture_syncs, bad = _syncs_inside_chunks(marks, caught)
        if bad:
            raise AssertionError(f"{phase} ({label}): host syncs inside chunks: {bad[:5]}")
        if not (_same_results(got, want) and _same_results(again, want)):
            raise AssertionError(f"{phase} ({label}): the captured program's results are not "
                                 "the eager body's bit for bit")
        if not (g_launch == e_launch == a_launch):
            raise AssertionError(f"{phase} ({label}): launches eager {e_launch}, captured "
                                 f"{g_launch}, second call {a_launch}")
        if prog.captures != 1 or replays_first < 1:
            raise AssertionError(f"{phase} ({label}): {prog.captures} captures, "
                                 f"{replays_first} replays in the first call")
        ref_tok, ref_top2 = _int_pos_decode(tr, mel)
        tie = _tie_check(phase, f"{label}: captured vs int pos", list(enumerate(got[0])),
                         {j: (ref_tok[j], ref_top2[j]) for j in range(b)})
        steps = _decode_launches(g_launch) // (2 * n_layers)
        return dict(
            batch=b, max_len=max_len, decode_steps=steps, equal_to_eager_body=True,
            launches_equal=True, launches=g_launch,
            launches_per_replay=prog.launches_per_replay(),
            eager_wall_s=e_wall, graph_first_call_wall_s=g_wall, graph_wall_s=a_wall,
            eager_decode_s=e_dec, graph_first_call_decode_s=g_dec, graph_decode_s=a_dec,
            eager_ms_per_step=e_dec * 1e3 / steps, graph_ms_per_step=a_dec * 1e3 / steps,
            capture_s=prog.capture_s, captures=prog.captures,
            replays_first_call=replays_first, replays_second_call=prog.replays - replays_first,
            pool_bytes=prog.pool_bytes, workspace_bytes=ws.buffer_bytes(),
            held_after_call_bytes=held_after, early_exit_syncs=checks,
            capture_syncs=capture_syncs, syncs_inside_chunks=0,
            parent_route=dict(tie, rows_equal=tie["rows_checked"] - tie["rows_diverging"]))
    finally:
        tr.max_len = saved


# ------------------------------------------------------------------ e2e-auto

AUTO_MAX_LEN = 224  # positions a window: bench.py::bench_one's decode length
AUTO_BEAMS = 5
AUTO_CHECK = 16  # windows decoded again at batch 16 for the token checks
AUTO_SEED = SEED + 30  # the windows' noise
# Above world 1, e2e-mesh decodes e2e-auto's large-v3-turbo int8 windows
# over the mesh: the directory and the rows it holds them to.
_AUTO_SHARED: dict = {}
# The batch auto resolved to, by case (the batch-dependence check's).
_AUTO_BATCHES: dict = {}


def _auto_windows(n: int, n_samples: int):
    """``n`` one-window requests of noise from ``AUTO_SEED``."""
    import numpy as np

    rng = np.random.default_rng(AUTO_SEED)
    return [0.1 * rng.standard_normal(n_samples, dtype=np.float32) for _ in range(n)]


def _watch_steps(tr, caught: list) -> tuple:
    """Marks where the decode loops of ``tr`` run, with how many warnings
    ``caught`` held (sync debug mode "warn" adds one per host sync): each
    step driven with an int position (a prefill, beam search's steps) as
    ("step", pos, warnings), and each chunk of a captured program
    (``infer/graphs.py``) as a span ("warm-up" | "first" | "replay",
    warnings at its start, at its end); "first" is a program's first call,
    its warm-up chunk and then its capture. Returns (the marks, the
    function that takes the watch off)."""
    from yoho_tpu_torch.infer.graphs import ChunkGraph

    marks, make = [], tr._make_step

    def make_step(ckv, model=None):
        step = make(ckv, model)

        def watched(tokens, caches, pos):
            if isinstance(pos, int):
                marks.append(("step", pos, len(caught)))
            return step(tokens, caches, pos)

        return watched

    def spanned(kind, fn):
        def run(self, *a, **k):
            mark = [kind, len(caught), None]
            marks.append(mark)
            try:
                return fn(self, *a, **k)
            finally:
                mark[2] = len(caught)
        return run

    saved = {n: ChunkGraph.__dict__[n] for n in ("_warm_up", "warm_and_capture", "replay")}
    ChunkGraph._warm_up = spanned("warm-up", saved["_warm_up"])
    ChunkGraph.warm_and_capture = spanned("first", saved["warm_and_capture"])
    ChunkGraph.replay = spanned("replay", saved["replay"])
    tr._make_step = make_step

    def undo():
        for n, f in saved.items():
            setattr(ChunkGraph, n, f)
        tr.__dict__.pop("_make_step", None)

    return marks, undo


def _syncs_inside_chunks(marks: list, caught: list) -> tuple:
    """The host syncs of a run against the decode loops' design. Eager
    steps (beam search): one early-exit check before every
    ``_SYNC_EVERY``-th step after the prefill, none anywhere else. Captured
    chunks: none inside a warm-up chunk or a replay, at most one (the
    early-exit check) between a batch's prefill or one chunk and the next
    chunk; a capture's own are counted apart. Returns (the early-exit
    syncs, the captures' syncs, the places that saw more: position or span,
    syncs and the lines that made them)."""
    from yoho_tpu_torch.infer.decode import _SYNC_EVERY

    def syncs(a, b):
        return [w for w in caught[a:b]
                if "called a synchronizing CUDA operation" in str(w.message)]

    def where(found):
        return sorted({f"{Path(w.filename).name}:{w.lineno}" for w in found})

    checks, captures, bad, first = 0, 0, [], 0
    steps = [m for m in marks if m[0] == "step"]
    chunked = any(m[0] != "step" for m in marks)
    for (_, a, ca), (_, b, cb) in zip(steps, steps[1:]):
        if b == 0 or chunked:  # the next batch's prefill; chunks are checked below
            continue
        if a == 0:
            first = b
        found = syncs(ca, cb)
        allowed = 1 if (b - first) % _SYNC_EVERY == 0 else 0
        checks += min(len(found), allowed)
        if len(found) > allowed:
            bad.append(dict(pos=b, syncs=len(found), where=where(found)))
    # The captured programs: each chunk span, and the gap before it back
    # to the end of the chunk before or to the batch's prefill.
    prev_end, pending = None, None
    for m in marks:
        kind, start, end = m
        if kind == "step":
            prev_end = end  # a prefill: the warnings at its start
            continue
        if kind in ("first", "replay") and prev_end is not None:
            gap = syncs(prev_end, start)
            checks += min(len(gap), 1)
            if len(gap) > 1:
                bad.append(dict(span=f"before a {kind}", syncs=len(gap), where=where(gap)))
        if kind in ("warm-up", "replay"):
            found = syncs(start, end)
            if found:
                bad.append(dict(span=kind, syncs=len(found), where=where(found)))
        if kind == "warm-up" and pending is not None:  # the rest of its first call
            captures += len(syncs(pending[1], pending[2])) - len(syncs(start, end))
            pending = None
        if kind == "first":
            pending = m
        if kind in ("first", "replay"):
            prev_end = end
    return checks, captures, bad


def _beam_candidates(record: list):
    """Patches beam search's top-k so that each call (one a step) also
    keeps each stream's 2K best candidates: their summed logprobs and their
    indices (beam x vocab + token). Returns the function that undoes it."""
    import torch

    from yoho_tpu_torch.infer import beam as beam_mod

    real = beam_mod.top_k

    def recording(x, k):
        record.append(torch.topk(x, 2 * k, dim=-1))
        return real(x, k)

    beam_mod.top_k = recording

    def undo():
        beam_mod.top_k = real

    return undo


def _beam_tie_check(phase: str, rows, ref_rows, cands, prompt_len: int, vocab: int) -> dict:
    """Each beam-search row against the same window's row at batch 16:
    equal, or first different at a position i where the two candidates the
    rows take there (one beam of the shared prefix extended by either
    token) have summed logprobs within ``_tie_check``'s margin, 4 bf16 ulps
    of the larger, in the batch-16 run's scores (its 2K best candidates
    each step, ``_beam_candidates``)."""
    import numpy as np

    vals = np.stack([c.values.float().cpu().numpy() for c in cands])  # (steps, B, 2K)
    idx = np.stack([c.indices.cpu().numpy() for c in cands])
    equal, worst, firsts = 0, 0.0, []
    for j, (got, want) in enumerate(zip(rows, ref_rows)):
        got, want = np.asarray(got), np.asarray(want)
        diff = np.flatnonzero(got != want)
        if len(diff) == 0:
            equal += 1
            continue
        i = int(diff[0])
        step = i - prompt_len
        firsts.append(step)
        if not 0 <= step < len(vals):
            raise AssertionError(f"{phase}: beams row {j} leaves the batch-16 row at {i}, "
                                 f"outside its {len(vals)} steps")
        score = {}
        for s, c in zip(vals[step, j], idx[step, j]):
            score[(int(c) // vocab, int(c) % vocab)] = float(s)
        pairs = [(score[(bm, int(want[i]))], score[(bm, int(got[i]))])
                 for bm in {bm for bm, _ in score}
                 if (bm, int(want[i])) in score and (bm, int(got[i])) in score]
        if not pairs:
            raise AssertionError(f"{phase}: beams row {j} leaves the batch-16 row at {i} "
                                 f"with token {int(got[i])}, not among that run's best "
                                 f"{vals.shape[-1]} candidates there beside {int(want[i])}")
        a, b = min(pairs, key=lambda p: abs(p[0] - p[1]))
        ulp = 2.0 ** (np.floor(np.log2(max(abs(a), abs(b)))) - 7)
        worst = max(worst, abs(a - b) / ulp)
        if abs(a - b) > 4 * ulp:
            raise AssertionError(f"{phase}: beams row {j} leaves the batch-16 row at {i} "
                                 f"where the candidates score {a} and {b} "
                                 f"({abs(a - b) / ulp} bf16 ulps apart)")
    return dict(rows_checked=len(rows), rows_equal=equal,
                first_difference_steps=sorted(firsts),
                largest_margin_at_divergence_bf16_ulps=worst)


def _auto_run(phase: str, label: str, tr, wins, kernels, n_layers: int, horizon: int):
    """One ``transcribe_many`` of ``wins``, one batch of ``tr``'s resolved
    ``auto`` size, with every launch count set to 0 just before and read
    just after, the peak memory above what was held, and sync debug mode
    "warn" with each host sync placed between decode steps. Fails unless
    the batch decoded is the batch resolved, the peak is at or below the
    capacity model's bytes for that batch (at ``horizon``, the positions
    its caches hold) and no host sync fell inside a decode chunk. A greedy
    case then makes a repeated call and runs the eager body (the module
    doc, item 13). Returns (the line's fields, the decoded rows, their
    top-2 logits)."""
    import warnings

    import numpy as np
    import torch

    from yoho_tpu_torch.infer import capacity

    auto = tr.batch_size
    raw, top2 = _mesh_recorded(tr)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            marks, undo = _watch_steps(tr, caught)
            try:
                results = tr.transcribe_many(wins)
                torch.cuda.synchronize()
            finally:
                undo()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del tr._logits_fn, tr._decode_with_fallback
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    held_after = torch.cuda.memory_allocated() - held
    launches = {k.name: k.launches for k in kernels}
    checks, capture_syncs, bad = _syncs_inside_chunks(marks, caught)
    if bad:
        raise AssertionError(f"{phase} ({label}): host syncs inside decode chunks: {bad[:5]}")
    decoded = [int(r.shape[0]) for r in raw]
    if len(wins) != auto or decoded != [auto]:
        raise AssertionError(f"{phase} ({label}): {len(wins)} windows decoded in batches "
                             f"{decoded}; auto resolved {auto}")
    per_stream = sum(capacity.stream_terms(tr.model.cfg, tr.family, **capacity._lane_kwargs(
        tr, tr.model, horizon)).values())
    if peak > auto * per_stream:
        raise AssertionError(f"{phase} ({label}): {peak} bytes above what was held at batch "
                             f"{auto}, the capacity model {auto * per_stream}")
    seconds = len(wins) * tr.chunk_samples / tr.sample_rate
    steps = _decode_launches(launches) // (2 * n_layers)
    row = dict(auto_batch=auto, batch_decoded=decoded[0], windows=len(wins),
               max_len=tr.max_len, wall_s=wall, decode_steps=steps,
               audio_s_per_s=seconds / wall, peak_bytes_above_held=peak, held_bytes=held,
               held_after_call_bytes=held_after,
               weight_bytes=capacity.module_bytes(tr.model),
               predicted_bytes=auto * per_stream, predicted_bytes_per_stream=per_stream,
               segments=sum(len(r.segments) for r in results), early_exit_syncs=checks,
               syncs_inside_chunks=0, launches=launches)
    if tr.beams <= 1:
        # A repeated call (replays only: it captures nothing), with the
        # programs' buffers held: its peak above what was held before the
        # first call is held to the capacity model too. Then the same chunk
        # body run eagerly on the same log-mel, bit-equal to the repeated
        # call's decode.
        p = len(tr._prompt_ids())
        ws = tr._workspaces[auto]
        prog = ws.graphs[(0.0, p)]
        decoded, decode = [], tr._decode_with_fallback

        def keep(*a, **k):
            decoded.append(decode(*a, **k))
            return decoded[-1]

        tr._decode_with_fallback = keep
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with _DecodeTimer() as timer:
                tr.transcribe_many(wins)
            torch.cuda.synchronize()
        finally:
            del tr._decode_with_fallback
        a_wall, a_dec = time.perf_counter() - t0, sum(timer.seconds)
        a_peak = torch.cuda.max_memory_allocated() - held
        a_launch = {k.name: k.launches for k in kernels}
        mel = tr._features(np.stack(wins))
        eager, e_wall, e_dec, e_launch = _timed_program(
            tr._build_decode_fn(auto, 0.0, p, captured=False), mel, kernels)
        got = decoded[0]
        same = _same_results((got[0], got[1], {k: got[2][k] for k in eager[2]}), eager)
        if a_peak > auto * per_stream:
            raise AssertionError(f"{phase} ({label}): the repeated call's {a_peak} bytes "
                                 f"above what was held before the first call at batch "
                                 f"{auto}, the capacity model {auto * per_stream}")
        if prog.captures != 1 or not same or len(decoded) != 1 \
                or _decode_launches(a_launch) != _decode_launches(e_launch):
            raise AssertionError(f"{phase} ({label}): {prog.captures} captures; the repeated "
                                 f"call's results equal to the eager body's: {same}; decode "
                                 f"launches {a_launch} against {e_launch}")
        row.update(capture_s=prog.capture_s, capture_syncs=capture_syncs,
                   pool_bytes=prog.pool_bytes, workspace_bytes=ws.buffer_bytes(),
                   repeated_call_wall_s=a_wall, repeated_call_peak_bytes_above_held=a_peak,
                   graph_decode_s=a_dec, eager_decode_s=e_dec, eager_wall_s=e_wall,
                   graph_ms_per_step=a_dec * 1e3 / steps, eager_ms_per_step=e_dec * 1e3 / steps,
                   equal_to_eager_body=True, repeated_call_captures=0,
                   launches_per_replay=prog.launches_per_replay())
        del eager, decoded, mel
    return row, raw, top2


def e2e_auto(card: str, kernels) -> dict:
    """Phase e2e-auto: the serving path at the batch ``batch="auto"``
    resolves to on this card (the module doc, item 13). Returns the
    launches of its measured runs."""
    import gc
    import shutil
    import tempfile

    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer import capacity
    from yoho_tpu_torch.load import load_transcriber
    from yoho_tpu_torch.nn.export import export_hf_whisper
    from yoho_tpu_torch.nn.params import init_random, to_jax_params
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8

    phase = "e2e-auto"
    total = {k.name: 0 for k in kernels}
    tmp = tempfile.TemporaryDirectory(prefix="yoho_auto_smoke_")
    root = Path(tmp.name)

    def whisper_dir(preset):
        """An HF directory of seed-0 random f32 weights (made on the card)."""
        cfg = WHISPER_PRESETS[preset]
        with torch.no_grad():
            model = init_random(Whisper(cfg, dtype=torch.float32, device="cuda"), seed=SEED)
            export_hf_whisper(to_jax_params(model), cfg, root / preset)
        del model
        torch.cuda.empty_cache()
        return cfg, str(root / preset)

    def case(label, cfg, load, n_layers, slope, beams=0):
        """``load(batch)`` -> a transcriber. The first 16 windows at batch
        16 (the same transcriber: the reference of the token check), the
        measured run at the resolved batch, the bytes per stream measured
        between auto / 2 and auto. Returns the run's rows and top-2."""
        t0 = time.perf_counter()
        tr = load("auto")
        auto, horizon = tr.batch_size, tr.max_len  # auto was sized for the caches' horizon
        _AUTO_BATCHES[label] = auto
        wins = _auto_windows(auto, tr.chunk_samples)
        tr.max_len = SERVE_MAX_LEN if beams else AUTO_MAX_LEN
        tr.batch_size = AUTO_CHECK
        ref_raw, ref_top2 = _mesh_recorded(tr)
        cands: list = []
        undo = _beam_candidates(cands) if beams else (lambda: None)
        try:
            tr.transcribe_many(wins[:AUTO_CHECK])
        finally:
            undo()
            del tr._logits_fn, tr._decode_with_fallback
        tr.batch_size = auto
        row, raw, top2 = _auto_run(phase, label, tr, wins, kernels, n_layers, horizon)
        idle = _never_launched(row["launches"], skip=(W8A8.name,))
        if idle or (row["launches"][W8A8.name] > 0) != bool(
                getattr(tr.model, "encoder_int8", False)):
            raise AssertionError(f"{phase} ({label}): launches {row['launches']}")
        for n, v in row["launches"].items():
            total[n] += v
        got = [raw[0][j] for j in range(AUTO_CHECK)]
        if beams:
            row["token_check"] = _beam_tie_check(phase, got, ref_raw[0], cands,
                                                 len(tr._prompt_ids()), cfg.n_vocab)
        else:
            tie = _tie_check(phase, label, list(enumerate(got)),
                             {j: (ref_raw[0][j], ref_top2[0][j].float().cpu().numpy())
                              for j in range(AUTO_CHECK)})
            row["token_check"] = dict(tie, rows_equal=tie["rows_checked"]
                                      - tie["rows_diverging"])
        terms = capacity.stream_terms(cfg, tr.family,
                                      **capacity._lane_kwargs(tr, tr.model, horizon))
        model = tr.model
        del tr  # its programs hold the captured buffers: collected before the slope
        gc.collect()
        torch.cuda.empty_cache()
        measured = slope(model, cfg, (auto // 2, auto), beams)
        del model
        row.update(measured_bytes_per_stream=measured["per_stream"],
                   measured_peak_bytes=measured["peak_bytes"], predicted_terms=terms,
                   case_s=time.perf_counter() - t0)
        emit(phase, config=label, card=card, **row)
        if measured["per_stream"] > sum(terms.values()):
            raise AssertionError(f"{phase} ({label}): {measured['per_stream']} B per stream "
                                 f"measured between {auto // 2} and {auto}, "
                                 f"{sum(terms.values())} predicted")
        return raw, top2

    def yoho_slope(model, cfg, batches, beams):
        return _yoho_stream_bytes_on_card(model, cfg, batches)

    def whisper_slope(model, cfg, batches, beams):
        return _stream_bytes_on_card(model, cfg, batches, beams=beams)

    try:
        cfg, hf = whisper_dir("small")
        for label, beams in (("whisper-small", 0), ("whisper-small-beams-5", AUTO_BEAMS)):
            case(label, cfg, lambda b, beams=beams: load_transcriber(
                hf=hf, batch=b, beams=beams, int8_kv=True), cfg.n_text_layer,
                whisper_slope, beams)
        shutil.rmtree(hf)

        cfg, hf = whisper_dir("large-v3-turbo")
        raw, top2 = case("large-v3-turbo-int8", cfg, lambda b: load_transcriber(
            hf=hf, batch=b, int8_kv=True, int8_weights=True, int8_encoder=True,
            fast_gelu=True), cfg.n_text_layer, whisper_slope)
        if torch.cuda.device_count() > 1:  # e2e-mesh decodes them again over the mesh
            _AUTO_SHARED.update(tmp=tmp, hf=hf, rows=raw[0],
                                top2=top2[0].float().cpu().numpy())
        else:
            shutil.rmtree(hf)

        config, _ = _write_yoho_session(root / "sessions", "default")
        case("yoho-default", config.yoho, lambda b: load_transcriber(
            session="default", root=str(root / "sessions"), batch=b),
            config.yoho.n_text_blocks, yoho_slope)
        _batch_dependence_f32(phase, card)
    finally:
        if "tmp" not in _AUTO_SHARED:
            tmp.cleanup()
        torch.cuda.empty_cache()
    return total


def _batch_dependence_f32(phase: str, card: str) -> None:
    """Whether a window's tokens depend on the batch it decodes in, in
    float32 (``core/device.py::full_fp32``: no TF32 in the products or the
    convolutions): whisper-small's widths at 2 + 2 layers (seed-0 random
    weights, float cross K/V and caches), the same 16 windows of noise at
    batch 16 and as the first 16 of ``auto_batch`` windows at the batch
    ``auto`` resolves to for whisper-small, ``AUTO_MAX_LEN`` positions a
    window. Prints the rows equal and each other row's first difference:
    the finding is the line, and no outcome fails the phase."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.core.device import full_fp32
    from yoho_tpu_torch.infer.pipeline import Transcriber
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.text.whisper_tokens import WhisperTokenTable

    cfg = dataclasses.replace(WHISPER_PRESETS["small"], n_audio_layer=2, n_text_layer=2)
    model = init_random(Whisper(cfg, dtype=torch.float32), seed=SEED)
    table = WhisperTokenTable(multilingual=True, text_backend=_IdText())
    tr = Transcriber(model, token_table=table, batch_size=BATCH, cache_dtype=torch.float32)
    tr.max_len = AUTO_MAX_LEN
    big = max(_AUTO_BATCHES.get("whisper-small", 0), 2 * BATCH)
    wins = np.stack(_auto_windows(big, tr.chunk_samples))
    t0 = time.perf_counter()
    with full_fp32():
        small = tr._decode_fn(BATCH)(tr._features(wins[:BATCH]))[0]
        large = tr._decode_fn(big)(tr._features(wins))[0][:BATCH]
    rows = []
    for j, (a, b) in enumerate(zip(small, large)):
        diff = np.flatnonzero(a != b)
        rows.append(None if len(diff) == 0 else int(diff[0]))
    equal = sum(r is None for r in rows)
    emit(phase, config="whisper-small widths, 2 + 2 layers, f32 (batch dependence)",
         card=card, batches=[BATCH, big], windows=BATCH, max_len=tr.max_len,
         rows_equal=equal, first_differences={j: r for j, r in enumerate(rows) if r is not None},
         distinct_rows=len({tuple(r) for r in small}), seconds=time.perf_counter() - t0)
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()


MESH_MAX_WORLD = 4


def _mesh_predicted(cfg, family: str, world: int, batches: int, steps: int):
    """The comm layer's collectives one rank makes for ``batches`` decoded
    batches of ``steps`` decode steps in all on a 1 x ``world`` mesh: a
    layer is sharded when the partition rules shard it (attention by whole
    KV-head groups, the vocabulary when its rows divide the axis), so each
    sharded attention and MLP reduces once per pass, the sharded embedding
    reduces its lookup and gathers the logits once per step, and each of
    the decode program's 4 result arrays (the YOHO family's voiceprint
    pass: one more, with a decoder pass over the decode's encoder output,
    which makes no logits) is gathered over ``data`` once per batch. Returns (counts, all-reduces per encode,
    all-reduces per decode step)."""
    if family == "whisper":
        heads = cfg.n_text_head
        attn = int(heads % world == 0)
        enc = cfg.n_audio_layer * (attn + 1)
        dec = cfg.n_text_layer * (2 * attn + 1)
        vocab, passes = cfg.n_vocab, 0
    else:
        q, kvh = cfg.n_audio_heads, max(1, cfg.n_audio_heads // 2)
        attn = int(q % world == 0 and kvh % world == 0)
        enc = cfg.n_audio_blocks * (attn + 1)
        dec = cfg.n_text_blocks * (2 * attn + 1)
        vocab, passes = 16000, batches
    emb = int(vocab % world == 0)
    out = {"all_reduce/model": batches * enc + steps * (dec + emb) + passes * (dec + emb),
           "all_gather/model": emb * steps,
           "all_gather/data": 4 * batches + passes}
    return {k: v for k, v in out.items() if v}, enc, dec + emb


def _put_top2(buf, out, pos) -> None:
    """Writes the top-2 of the processed logits ``out`` (B, V) into ``buf``
    (B, T, 2) at buffer index ``pos``: an int (a prefill's pick, beam
    search's steps) or a per-row tensor (a greedy or slot chunk, where the
    write is a scatter on the device that a captured chunk replays). ``buf``
    holds the padding the last chunk writes past ``max_len``."""
    import torch

    vals = torch.topk(out, 2, dim=-1).values
    if isinstance(pos, int):
        buf[:, pos] = vals
    else:
        buf.scatter_(1, pos.long()[:, None, None].expand(-1, 1, 2), vals[:, None, :])


def _mesh_recorded(tr) -> tuple:
    """Patches a transcriber to keep the raw tokens of each batch it
    decodes and, per batch, the top-2 of its processed logits at each
    (row, position): ``_tie_check``'s reference. Returns the two lists.
    The top-2 of a batch is written into one buffer per (rows, width),
    which a captured chunk reads at a fixed address; the next batch's
    first pick keeps a copy of the last one's."""
    import torch

    raw, top2, live = [], [], {}
    build, decode = tr._logits_fn, tr._decode_with_fallback

    def recording(prompt_len):
        rules = build(prompt_len)

        def fn(logits, tokens, pos):
            out = logits if rules is None else rules(logits, tokens, pos)
            key = (out.shape[0], tokens.shape[1])
            if isinstance(pos, int) and pos == prompt_len:  # a new batch's first pick
                if top2:
                    top2[-1] = top2[-1].clone()
                if key not in live:
                    live[key] = torch.empty(key + (2,), device=out.device)
                top2.append(live[key].fill_(float("nan")))
            _put_top2(live[key], out, pos)
            return out

        return fn

    def recorded(*args, **kw):
        out = decode(*args, **kw)
        raw.append(out[0])
        return out

    tr._logits_fn, tr._decode_with_fallback = recording, recorded
    return raw, top2


def _mesh_tie_check(phase: str, label: str, world: int, ref_raw, ref_top2, mesh_raw) -> dict:
    """The mesh path's raw decode rows against the unsharded path's, batch
    by batch: equal at world 1 (a group of one computes the unsharded
    arithmetic); above it, equal up to a first difference inside a tie
    (``_tie_check``: in bf16 each rank rounds its partial sums)."""
    if len(ref_raw) != len(mesh_raw):
        raise AssertionError(f"{phase} ({label}): {len(mesh_raw)} batches decoded over the "
                             f"mesh, {len(ref_raw)} unsharded")
    out = dict(rows_checked=0, rows_diverging=0, largest_margin_at_divergence_bf16_ulps=0.0)
    for ref, top2, got in zip(ref_raw, ref_top2, mesh_raw):
        top2 = top2.float().cpu().numpy()
        tie = _tie_check(phase, label, list(enumerate(got)),
                         {j: (ref[j], top2[j]) for j in range(len(ref))})
        out["rows_checked"] += tie["rows_checked"]
        out["rows_diverging"] += tie["rows_diverging"]
        out["largest_margin_at_divergence_bf16_ulps"] = max(
            out["largest_margin_at_divergence_bf16_ulps"],
            tie["largest_margin_at_divergence_bf16_ulps"])
    if world == 1 and out["rows_diverging"]:
        raise AssertionError(f"{phase} ({label}): {out['rows_diverging']} rows differ at world 1")
    return out


SERVE_CHUNK = 16  # chunk_tokens of e2e-mesh's served runs (e2e-serve's)


def _serve_predicted(cfg, family: str, world: int, stats: dict, ticks: int,
                     gamma: int = 0, passes: int = 0) -> dict:
    """The comm layer's collectives of one run of the slot engine over a
    1 x ``world`` mesh, from its engine's ``stats`` (chunks and reaps since
    the run began) and its batcher's schedule ``ticks``: each admission
    (reaps less chunks: the batcher reaps once after an admission and once
    in every chunk) encodes (the draft too with ``gamma``) and prefills
    once; a chunk is ``SERVE_CHUNK`` decode steps, or with ``gamma`` its
    rounds of gamma draft steps and one verify step; each step and encode
    as ``_mesh_predicted`` counts them (with the vocabulary's gather over
    ``model`` a step); each reap gathers the slots over ``data`` once, in
    one packed gather; each tick broadcasts the schedule, and the ranks
    agree on the outcome after each admission and at the end of each tick
    but the run's last (the close's stop tick; ``world``: the host's gloo
    group). A YOHO request's
    voiceprint pass (``passes``) encodes, runs the decoder once (no
    logits) and gathers its rows over ``data``."""
    _counts, enc, step = _mesh_predicted(cfg, family, world, 0, 0)
    emb = _mesh_predicted(cfg, family, world, 0, 1)[0].get("all_gather/model", 0)
    chunks = stats["chunks"]
    admits = stats["reaps"] - chunks
    if gamma:
        rounds = chunks * max(1, SERVE_CHUNK // (gamma + 1))
        encodes, steps = 2 * admits, 2 * admits + rounds * (gamma + 1)
    else:
        encodes, steps = admits, admits + chunks * SERVE_CHUNK
    out = {"all_reduce/model": (encodes + passes) * enc + (steps + passes) * step,
           "all_gather/model": steps * emb,
           "all_gather/data": stats["reaps"] + passes,
           "broadcast_obj/world": ticks, "all_reduce/world": ticks - 1 + admits}
    return {k: v for k, v in out.items() if v}


def _rank_stats(stats: dict) -> list:
    """Every rank's ``stats`` (a dict), in rank order."""
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, stats)
    return got


def _served_rows_check(phase: str, label: str, world: int, rows, ref, equal_to=None) -> dict:
    """A served run's rows against the references: equal to ``equal_to``'s
    rows of the same windows at world 1 (when given), and inside a tie of
    the greedy reference ``ref`` (``_tie_check``) at any world."""
    out = _tie_check(phase, label, rows, ref)
    if equal_to is not None:
        want = dict(equal_to)
        differ = sum(not _same_tokens(tok, want[key]) for key, tok in rows)
        if world == 1 and differ:
            raise AssertionError(f"{phase} ({label}): {differ} of {len(rows)} rows differ "
                                 "from the unsharded engine's at world 1")
        out["rows_differing_from_unsharded"] = differ
    return out


def _same_tokens(a, b) -> bool:
    import numpy as np

    return np.array_equal(np.asarray(a), np.asarray(b))


def _served_transcriber(model, table, mesh=None, **kw):
    """e2e-mesh's whisper-small transcriber settings (``load_transcriber``'s
    with int8 K/V) over ``model``, already loaded (and sharded over
    ``mesh``), decoding ``SERVE_MAX_LEN`` positions a window."""
    import torch

    from yoho_tpu_torch.infer.pipeline import Transcriber

    tr = Transcriber(model, family="whisper", token_table=table, batch_size=BATCH,
                     language="en", cache_dtype=torch.bfloat16, timestamps=True,
                     quantized_cross_kv=True, quantized_cache=True, mesh=mesh,
                     device=model.device, **kw)
    tr.max_len = SERVE_MAX_LEN
    return tr


def _mesh_serve(phase: str, world: int, lead: bool, mesh, cfg, sharded, plain, kernels,
                total: dict) -> dict:
    """Part (d) of phase e2e-mesh (the module doc, item 15): whisper-small
    served over the mesh (``sharded``'s model), rank 0 serving and the
    other ranks following its schedule (``cli/serve.py::follow``), against
    ``plain``'s unsharded model. Returns the part's report on rank 0 (an
    empty one elsewhere)."""
    import threading
    from collections import Counter
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from yoho_tpu_torch.cli.serve import drain, follow, serve, warmup
    from yoho_tpu_torch.infer.batching import RequestCancelled
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.parallel import mesh as pm

    sr, audios = 16000, _requests()
    seconds = [len(a) / sr for a in audios]
    table = sharded.token_table
    served_tr = _served_transcriber(sharded.model, table, mesh)
    spec_tr = _served_transcriber(sharded.model, table, mesh, draft_model=sharded.model,
                                  speculative_gamma=SPEC_GAMMA)
    ref_tr = _served_transcriber(plain.model, table)
    (_ref_raw, ref_top2), (mesh_batches, _) = _mesh_recorded(ref_tr), _mesh_recorded(served_tr)
    rows_local, heads_local = BATCH // mesh.shape["data"], cfg.n_text_head // world
    seen = {}  # window key -> the window, padded (every window served)

    def key_of(window):
        padded = np.zeros(sharded.chunk_samples, np.float32)
        padded[:len(window)] = window
        key = _window_key(padded)
        seen.setdefault(key, padded)
        return key

    # Every decode-attention launch: whether it ran inside a chunk, its
    # rows, queries, causal position kind and query / KV heads.
    shapes: Counter = Counter()
    in_chunk = [False]

    def recording_launch(args):
        shapes[(in_chunk[0], args[8], args[11], "per-row pos" if args[17] is not None
                else "scalar pos" if args[15] else "no pos", args[9], args[10])] += 1

    def hooks(engine, rows, target=None):
        """Runs each chunk of ``engine`` with the launch flag set and with
        PyTorch's sync debug mode raising on a host sync; records each
        reap's windows in ``rows`` and the chunk of each release. Returns
        the release chunks and a ``cancelled`` predicate for the request
        whose audio is ``target``: it turns true once a chunk has run with
        that request in a slot, and that chunk's tick waits until the
        submitter has seen it, so the cancel frees the slot at the next
        tick whatever the timing of the other requests."""
        chunk, reap, release = engine._chunk, engine.reap, engine.release
        freed, go, seen_go = [], threading.Event(), threading.Event()

        def checked(state):
            in_chunk[0] = True
            torch.cuda.set_sync_debug_mode("error")
            try:
                chunk(state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                in_chunk[0] = False
            if target is not None and not go.is_set() and any(
                    w is not None and w.req is not None and w.req.audio is target
                    for w in engine._occupied):
                go.set()
                if not seen_go.wait(timeout=30):
                    raise AssertionError(f"{phase}: the cancelling client never polled")

        def cancelled():
            if go.is_set():
                seen_go.set()
                return True
            return False

        def capturing():
            got = reap()
            rows.extend((key_of(w.window), w.tokens) for w in got)
            return got

        def recorded(pred):
            n = release(pred)
            if n:
                freed.append(engine.stats["chunks"])
            return n

        engine._chunk, engine.reap, engine.release = checked, capturing, recorded
        return freed, cancelled

    def served(label, tr, continuous, stream=True, cancel=False):
        """``tr`` served over the mesh after ``warmup``: the three requests
        to /transcribe at once, the 75 s one also as a /stream session in 1
        s frames, and (``cancel``) the 30 s one submitted by a client that
        goes away once a chunk has run; then ``drain``. Launches and
        collectives counted from just after the warmup to the end of the
        drain (its stop tick)."""
        if not lead:
            b = follow(tr, continuous=continuous, chunk_tokens=SERVE_CHUNK)
            b.join()
            _rank_stats(dict(b.engine.stats) if continuous else {})
            return {}
        server = serve(tr, port=0, continuous=continuous, chunk_tokens=SERVE_CHUNK)
        b, rows = server.batcher, []
        engine = b.engine if continuous else None
        freed, cancelled = (hooks(engine, rows, audios[1] if cancel else None)
                            if continuous else ([], None))
        if not continuous:
            features, decode = tr._features, tr._decode_with_fallback
            last = []

            def capturing_features(wins):
                last[:] = [np.asarray(wins, np.float32)]
                return features(wins)

            def capturing_decode(n, mel, prompt=None, **kw):
                res = decode(n, mel, prompt, **kw)
                rows.extend((key_of(w), t) for w, t in zip(last[0], res[0]) if w.any())
                return res

            tr._features, tr._decode_with_fallback = capturing_features, capturing_decode
        try:
            warmup(server)
            rows.clear()
            base = dict(engine.stats) if continuous else {}
            ticks0, channel0 = b.schedule.ticks, b.schedule.host_s
            batches0 = len(mesh_batches)
            dispatched0 = b.batches_dispatched
            url = f"http://127.0.0.1:{server.server_address[1]}"
            threading.Thread(target=server.serve_forever, daemon=True).start()
            shapes.clear()
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            pm.reset_counts()
            t0 = time.perf_counter()

            def cancelled_client():
                try:
                    b.submit(audios[1], cancelled=cancelled)
                except RequestCancelled:
                    return "cancelled"
                return "served"

            with ThreadPoolExecutor(5) as pool:
                futs = [pool.submit(_post, url, "/transcribe", a.astype("<f4").tobytes(),
                                    "application/octet-stream") for a in audios]
                if stream:
                    futs.append(pool.submit(_stream_session, phase, url, audios[2], sr))
                if cancel:
                    futs.append(pool.submit(cancelled_client))
                results = [f.result(timeout=900) for f in futs]
            t_drain = time.perf_counter()
            drain(server, timeout_s=30)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            drain_s = time.perf_counter() - t_drain
        finally:
            if not continuous:
                tr._features, tr._decode_with_fallback = features, decode
        launches = {k.name: k.launches for k in kernels}
        idle = _never_launched(launches, YOHO_PATH)
        if idle or launches[W8A8.name]:
            raise AssertionError(f"{phase} ({label}): kernels never launched {idle}, w8a8 "
                                 f"{launches[W8A8.name]}")
        for n, v in launches.items():
            total[n] += v
        ranks = _rank_stats(dict(engine.stats) if continuous else {})
        if any(r != ranks[0] for r in ranks):
            raise AssertionError(f"{phase} ({label}): the ranks' engine stats differ: {ranks}")
        bodies = [json.loads(r) for r in results[:3]]
        if any(not d["segments"] for d in bodies) or (stream and not results[3]):
            raise AssertionError(f"{phase} ({label}): a response without segments")
        if cancel and (results[-1] != "cancelled" or len(freed) != 1):
            raise AssertionError(f"{phase} ({label}): the cancelled request was "
                                 f"{results[-1]}, slots freed at chunks {freed}")
        ticks = b.schedule.ticks - ticks0
        audio_s = sum(seconds) + (seconds[2] if stream else 0)
        return dict(
            wall_s=wall, drain_s=drain_s, audio_s_per_s=audio_s / wall, ticks=ticks,
            channel_host_us_per_tick=(b.schedule.host_s - channel0) / max(ticks, 1) * 1e6,
            collectives=dict(pm.COUNTS), launches=launches,
            stats={k: v - base[k] for k, v in engine.stats.items()} if continuous else {},
            decode_batches=len(mesh_batches) - batches0,
            dispatches=b.batches_dispatched - dispatched0, rows=rows,
            cancelled_freed_after_chunks=(freed[0] - base["chunks"]) if freed else None,
            decode_launches=dict(shapes))

    unhook = _hook_decode(recording_launch)
    try:
        runs = {"slot engine": served("slot engine", served_tr, True, cancel=True),
                "micro-batcher": served("micro-batcher", served_tr, False),
                "speculative slots": served("speculative slots", spec_tr, True,
                                            stream=False)}
    finally:
        unhook()
    if not lead:
        return {}

    # The references, unsharded and not counted: the greedy batched decode
    # of every window served (transcribe_many's program, the micro-
    # batcher's) with its top-2 processed logits, and the unsharded
    # ContinuousBatcher (16 slots, the same chunks) on the same windows.
    from yoho_tpu_torch.infer.continuous import ContinuousBatcher

    keys = list(seen)
    ref = {}
    for i in range(0, len(keys), BATCH):
        group = keys[i:i + BATCH]
        batch = np.zeros((BATCH, ref_tr.chunk_samples), np.float32)
        for j, key in enumerate(group):
            batch[j] = seen[key]
        tokens = ref_tr._decode_with_fallback(BATCH, ref_tr._features(batch))[0]
        top2 = ref_top2[-1].float().cpu().numpy()
        ref.update({key: (tokens[j], top2[j]) for j, key in enumerate(group)})
    unsharded = []
    batcher = ContinuousBatcher(ref_tr, max_batch=BATCH, chunk_tokens=SERVE_CHUNK)
    reap = batcher.engine.reap

    def capturing():
        got = reap()
        unsharded.extend((key_of(w.window), w.tokens) for w in got)
        return got

    batcher.engine.reap = capturing
    try:
        with ThreadPoolExecutor(len(keys)) as pool:
            for f in [pool.submit(batcher.submit, seen[k], vad=False) for k in keys]:
                f.result(timeout=900)
    finally:
        batcher.close()

    out = {}
    for label, run in runs.items():
        if label == "micro-batcher":
            steps = _decode_launches(run["launches"]) // (2 * cfg.n_text_layer)
            predicted = _mesh_predicted(cfg, "whisper", world, run["decode_batches"], steps)[0]
            predicted.update({"broadcast_obj/world": run["ticks"],
                              "all_reduce/world": run["dispatches"]})
            check = _served_rows_check(phase, label, world, run["rows"], ref,
                                       equal_to=[(k, ref[k][0]) for k in ref])
        else:
            gamma = SPEC_GAMMA if label == "speculative slots" else 0
            predicted = _serve_predicted(cfg, "whisper", world, run["stats"], run["ticks"],
                                         gamma=gamma)
            check = _served_rows_check(phase, label, world, run["rows"], ref,
                                       equal_to=None if gamma else unsharded)
            inside = {k: n for k, n in run["decode_launches"].items() if k[0]}
            if gamma:
                rounds = run["stats"]["chunks"] * max(1, SERVE_CHUNK // (gamma + 1))
                verify = inside.get((True, rows_local, gamma + 1, "per-row pos",
                                     heads_local, heads_local), 0)
                bad = [k for k in inside if k[3] == "scalar pos" or k[1] != rows_local
                       or k[4] != heads_local]
                if verify != rounds * cfg.n_text_layer or bad:
                    raise AssertionError(f"{phase} ({label}): verify reads {verify} for "
                                         f"{rounds} rounds, other reads {bad}")
            else:
                per_kind = run["stats"]["chunks"] * SERVE_CHUNK * cfg.n_text_layer
                want = {(True, rows_local, 1, kind, heads_local, heads_local): per_kind
                        for kind in ("per-row pos", "no pos")}
                if inside != want:
                    raise AssertionError(f"{phase} ({label}): decode launches inside chunks "
                                         f"{inside}, expected {want}")
        if run["collectives"] != predicted:
            raise AssertionError(f"{phase} ({label}): collectives {run['collectives']}, "
                                 f"predicted {predicted}")
        run.pop("rows")
        run["decode_launches"] = {
            f"{'chunk' if k[0] else 'outside chunks'} B{k[1]} S{k[2]} {k[3]} H{k[4]}/{k[5]}": n
            for k, n in sorted(run["decode_launches"].items())}
        out[label] = dict(run, predicted=predicted, host_syncs_in_chunks=0, **check,
                          e2e_serve=_SERVE_WALLS.get(
                              "servers, micro-batcher" if label == "micro-batcher" else
                              "speculative slots" if label == "speculative slots" else
                              "servers, slot engine", "not measured in this process"))
    out["windows_served"] = len(keys)
    return out


def _mesh_serve_yoho(phase: str, world: int, lead: bool, ycfg, ysharded, yplain, ywins,
                     kernels, total: dict, yref_raw: list, yref_top2: list) -> dict:
    """Part (d)'s YOHO run: the default session's 16 windows as 16 requests
    at once through a ContinuousBatcher over the mesh (rank 0 submits, the
    other ranks follow), against the unsharded ContinuousBatcher on the
    same windows and the batched greedy rows. Returns the report on rank
    0."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from yoho_tpu_torch.infer.continuous import ContinuousBatcher
    from yoho_tpu_torch.parallel import mesh as pm

    width = ysharded.chunk_samples
    ysharded.max_len = yplain.max_len = SERVE_MAX_LEN  # their last use in the phase

    def key(window):  # a window as the slots hold it: padded to the window size
        return _window_key(np.pad(window, (0, width - len(window))))

    index = {key(w): j for j, w in enumerate(ywins)}

    def run(tr, check_chunks):
        b = ContinuousBatcher(tr, max_batch=BATCH, chunk_tokens=SERVE_CHUNK)
        if tr.mesh is not None and not lead:
            b.join()
            _rank_stats(dict(b.engine.stats))
            return None
        engine, rows = b.engine, []
        chunk, reap = engine._chunk, engine.reap

        def checked(state):
            torch.cuda.set_sync_debug_mode("error")
            try:
                chunk(state)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        def capturing():
            got = reap()
            rows.extend((index[key(w.window)], w.tokens) for w in got)
            return got

        engine.reap = capturing
        if check_chunks:
            engine._chunk = checked
        channel = b.schedule  # None unsharded
        ticks0 = channel.ticks if channel else 0
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        pm.reset_counts()
        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(len(ywins)) as pool:
                results = [f.result(timeout=900) for f in
                           [pool.submit(b.submit, w) for w in ywins]]
        finally:
            b.close()
        torch.cuda.synchronize()
        ticks = channel.ticks - ticks0 if channel else 0
        return dict(wall_s=time.perf_counter() - t0, ticks=ticks, rows=rows,
                    stats=dict(engine.stats), launches={k.name: k.launches for k in kernels},
                    collectives=dict(pm.COUNTS), results=results,
                    channel_host_us_per_tick=(channel.host_s / max(channel.ticks, 1) * 1e6
                                              if channel else None))

    got = run(ysharded, True)
    if not lead:
        return {}
    ranks = _rank_stats(got["stats"])
    if any(r != ranks[0] for r in ranks):
        raise AssertionError(f"{phase} (yoho, slot engine): the ranks' engine stats differ: "
                             f"{ranks}")
    idle = _never_launched(got["launches"], YOHO_PATH)
    if idle:
        raise AssertionError(f"{phase} (yoho, slot engine): kernels never launched {idle}")
    for n, v in got["launches"].items():
        total[n] += v
    want = run(yplain, False)  # the unsharded ContinuousBatcher, not counted
    ref = {j: (yref_raw[0][j], yref_top2[0][j].float().cpu().numpy())
           for j in range(len(ywins))}
    check = _served_rows_check(phase, "yoho, slot engine", world, got["rows"], ref,
                               equal_to=want["rows"])
    segments = sum(len(r.segments) for r in got["results"])
    predicted = _serve_predicted(ycfg, "yoho", world, got["stats"], got["ticks"],
                                 passes=len(ywins))
    if got["collectives"] != predicted or not segments:
        raise AssertionError(f"{phase} (yoho, slot engine): collectives "
                             f"{got['collectives']}, predicted {predicted}; {segments} "
                             "segments")
    return dict(wall_s=got["wall_s"], unsharded_wall_s=want["wall_s"], ticks=got["ticks"],
                channel_host_us_per_tick=got["channel_host_us_per_tick"],
                stats=got["stats"], collectives=got["collectives"], predicted=predicted,
                launches=got["launches"], segments=segments, host_syncs_in_chunks=0, **check)


def _mesh_auto(phase: str, world: int, mesh, path: str, measured) -> dict:
    """Above world 1: e2e-auto's large-v3-turbo int8 (its directory, both
    int8 lanes) through ``load_transcriber(mesh="1xW", batch="auto")`` on
    the same windows, each decoded row held to e2e-auto's row of the same
    window by ``_tie_check`` (in bf16 each rank rounds its partial sums)."""
    import pickle

    from yoho_tpu_torch.load import load_transcriber

    ref = pickle.loads(Path(path).read_bytes())
    tr = load_transcriber(hf=ref["hf"], batch="auto", mesh=mesh, int8_kv=True,
                          int8_weights=True, int8_encoder=True, fast_gelu=True)
    if tr.batch_size != len(ref["rows"]):
        raise AssertionError(f"{phase}: auto resolves to {tr.batch_size} over the mesh, "
                             f"{len(ref['rows'])} on one card")
    tr.max_len = AUTO_MAX_LEN
    wins = _auto_windows(tr.batch_size, tr.chunk_samples)
    raw, _ = _mesh_recorded(tr)
    measured("turbo-auto-mesh", lambda: tr.transcribe_many(wins), w8a8=True)
    if [len(r) for r in raw] != [len(wins)]:
        raise AssertionError(f"{phase}: decoded batches {[len(r) for r in raw]}, "
                             f"{len(wins)} windows")
    tie = _tie_check(phase, "large-v3-turbo-int8 auto", list(enumerate(raw[0])),
                     {j: (ref["rows"][j], ref["top2"][j]) for j in range(len(wins))})
    return dict(model="large-v3-turbo int8 (both lanes)", mesh=f"1x{world}",
                auto_batch=tr.batch_size, windows=len(wins), max_len=tr.max_len,
                tie_check_against_e2e_auto=tie)


def _mesh_rank(card: str, kernels, world: int) -> dict:
    """One rank of phase e2e-mesh (the module doc, item 15); rank 0 prints
    the phase's lines. Returns this rank's launches on the mesh path."""
    import tempfile

    import torch

    from yoho_tpu_torch.cli.transcribe import load_yoho_session
    from yoho_tpu_torch.core.config import WHISPER_PRESETS
    from yoho_tpu_torch.infer import capacity
    from yoho_tpu_torch.infer.longform import chunk_audio
    from yoho_tpu_torch.load import load_transcriber
    from yoho_tpu_torch.nn.export import export_hf_whisper
    from yoho_tpu_torch.nn.params import init_random, to_jax_params
    from yoho_tpu_torch.nn.whisper import Whisper
    from yoho_tpu_torch.ops.w8a8_dense import KERNEL as W8A8
    from yoho_tpu_torch.parallel import mesh as pm
    from yoho_tpu_torch.parallel.long_encoder import yoho_encode_long
    from yoho_tpu_torch.parallel.pipeline import pipeline_encode

    phase = "e2e-mesh"
    spec = f"1x{world}"
    lead = int(os.environ.get("RANK", 0)) == 0
    total = {k.name: 0 for k in kernels}
    report = {}

    def measured(label, fn, want=YOHO_PATH, w8a8=False, count=True):
        """Runs ``fn`` with every launch count and the comm layer's counts
        set to 0 just before it and read just after; ``count=False`` (the
        unsharded references) keeps its launches out of the phase's."""
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        pm.reset_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        idle = _never_launched(launches, want)
        if idle or (launches[W8A8.name] > 0) != w8a8:
            raise AssertionError(f"{phase} ({label}): launches {launches}")
        if count:
            for n, v in launches.items():
                total[n] += v
        report[label] = dict(wall_s=wall, launches=launches, collectives=dict(pm.COUNTS))
        return result

    def tokens(results):
        return [[int(x) for s in r.segments for x in s.tokens] for r in results]

    mesh = pm.parse_mesh(spec)  # NCCL; a group of one, in process, at world 1
    with tempfile.TemporaryDirectory(prefix="yoho_mesh_smoke_") as tmp:
        tmp = Path(tmp)
        # whisper-small from an HF directory of seed-0 random weights.
        cfg = WHISPER_PRESETS["small"]
        hf = tmp / "whisper-small"
        export_hf_whisper(to_jax_params(init_random(Whisper(cfg, dtype=torch.float32),
                                                    seed=SEED)), cfg, hf)
        audios = _requests()
        kw = dict(hf=str(hf), batch=BATCH, int8_kv=True)
        plain, sharded = load_transcriber(**kw), load_transcriber(mesh=mesh, **kw)
        (ref_raw, ref_top2), (mesh_raw, _) = _mesh_recorded(plain), _mesh_recorded(sharded)
        want = tokens(measured("whisper-plain", lambda: plain.transcribe_many(audios),
                               count=False))
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = tokens(measured("whisper-mesh", lambda: sharded.transcribe_many(audios)))
        peak = torch.cuda.max_memory_allocated() - before
        tie = _mesh_tie_check(phase, "whisper", world, ref_raw, ref_top2, mesh_raw)
        if world == 1 and got != want:
            raise AssertionError(f"{phase}: the mesh path's whisper tokens differ from "
                                 "the unsharded Transcriber's")
        windows = sum(len(chunk_audio(a, sharded.chunk_samples, sharded.stride_samples)[1])
                      for a in audios)
        batches = -(-windows // BATCH)
        run = report["whisper-mesh"]
        steps = _decode_launches(run["launches"]) // (2 * cfg.n_text_layer)
        predicted, per_encode, per_step = _mesh_predicted(cfg, "whisper", world, batches,
                                                          steps)
        if run["collectives"] != predicted:
            raise AssertionError(f"{phase}: collectives {run['collectives']}, "
                                 f"predicted {predicted}")
        # The capacity model's bytes for the batch on one rank: the K/V
        # terms hold this rank's heads, the rest is whole.
        terms = capacity.stream_terms(cfg, "whisper", **capacity._lane_kwargs(
            sharded, sharded.model, sharded.max_len))
        kv = terms["cross_kv"] + terms["self_cache"]
        per_rank = BATCH * (-(-kv // world) + sum(terms.values()) - kv)
        if peak > per_rank:
            raise AssertionError(f"{phase}: {peak} bytes above what was held, the capacity "
                                 f"model allows {per_rank} a rank")
        # (d) Serving over the mesh, the same transcribers.
        t_serve = time.perf_counter()
        serving = _mesh_serve(phase, world, lead, mesh, cfg, sharded, plain, kernels, total)
        serve_s = time.perf_counter() - t_serve
        whisper = dict(
            model="whisper-small", batch=BATCH, windows=windows, batches=batches,
            decode_steps=steps, tokens_equal_unsharded=got == want, tie_check=tie,
            collectives=run["collectives"],
            predicted=predicted, all_reduces_per_encode=per_encode,
            all_reduces_per_decode_step=per_step,
            wall_s={k: report[k]["wall_s"] for k in ("whisper-plain", "whisper-mesh")},
            peak_bytes_above_held=peak, capacity_bytes_per_rank=per_rank,
            weights_bytes_per_rank=capacity.module_bytes(sharded.model))
        del plain, sharded

        # --int8-encoder on one request: the W8A8 MLPs stay whole (their
        # int8 leaves match no sharding rule), and w8a8 launches.
        kw8 = dict(kw, int8_encoder=True)
        plain8, sharded8 = load_transcriber(**kw8), load_transcriber(mesh=mesh, **kw8)
        want8 = tokens([measured("whisper-int8-encoder-plain",
                                 lambda: plain8.transcribe(audios[0]), w8a8=True,
                                 count=False)])
        got8 = tokens([measured("whisper-int8-encoder-mesh",
                                lambda: sharded8.transcribe(audios[0]), w8a8=True)])
        w8a8_launches = report["whisper-int8-encoder-mesh"]["launches"][W8A8.name]
        if (world == 1 and got8 != want8) or w8a8_launches != 2 * cfg.n_audio_layer:
            raise AssertionError(f"{phase}: --int8-encoder tokens equal: {got8 == want8}, "
                                 f"w8a8 launches {w8a8_launches}")
        whisper["int8_encoder"] = dict(tokens_equal_unsharded=got8 == want8,
                                       w8a8_launches=w8a8_launches)
        del plain8, sharded8

        # The default YOHO session at full width.
        root = tmp / "sessions"
        config, _ = _write_yoho_session(root, "default")
        ycfg = config.yoho
        ykw = dict(session="default", root=str(root), batch=BATCH)
        yplain, ysharded = load_transcriber(**ykw), load_transcriber(mesh=mesh, **ykw)
        (yref_raw, yref_top2), (ymesh_raw, _) = _mesh_recorded(yplain), _mesh_recorded(ysharded)
        ywins = _yoho_windows(BATCH, SEED + 20)
        ywant = tokens(measured("yoho-plain", lambda: yplain.transcribe_many(ywins),
                                count=False))
        ygot = tokens(measured("yoho-mesh", lambda: ysharded.transcribe_many(ywins)))
        ytie = _mesh_tie_check(phase, "yoho", world, yref_raw, yref_top2, ymesh_raw)
        if world == 1 and ygot != ywant:
            raise AssertionError(f"{phase}: the mesh path's YOHO tokens differ")
        t_serve = time.perf_counter()
        yserving = _mesh_serve_yoho(phase, world, lead, ycfg, ysharded, yplain, ywins,
                                    kernels, total, yref_raw, yref_top2)
        serve_s += time.perf_counter() - t_serve
        yrun = report["yoho-mesh"]
        ysteps = _decode_launches(yrun["launches"]) // (2 * ycfg.n_text_blocks)
        ypred, y_encode, y_step = _mesh_predicted(ycfg, "yoho", world, 1, ysteps)
        if yrun["collectives"] != ypred:
            raise AssertionError(f"{phase}: YOHO collectives {yrun['collectives']}, "
                                 f"predicted {ypred}")
        yoho = dict(batch=BATCH, decode_steps=ysteps, tokens_equal_unsharded=ygot == ywant,
                    tie_check=ytie,
                    collectives=yrun["collectives"], predicted=ypred,
                    all_reduces_per_encode=y_encode, all_reduces_per_decode_step=y_step,
                    wall_s={k: report[k]["wall_s"] for k in ("yoho-plain", "yoho-mesh")})
        del yplain, ysharded

        # Sequence-parallel encoding at 4x the window and the pipelined
        # encoder, in f32 against encode_audio of the same input.
        _, m32 = load_yoho_session("default", str(root), dtype=torch.float32)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        long_mel = torch.randn((2, 4 * ycfg.max_audio_len, ycfg.n_mel_bands),
                               generator=gen, device="cuda")
        with torch.inference_mode():
            ref = m32.encode_audio(long_mel)
        seq = pm.init_mesh({"seq": world})
        out = measured("yoho-encode-long", lambda: yoho_encode_long(m32, long_mel, seq),
                       want=())
        err = float((out - ref).abs().max())
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        per_block = 2 * (world - 1) * ycfg.n_audio_blocks
        want_long = {k: v for k, v in {"send/seq": per_block, "recv/seq": per_block,
                                       "all_gather/seq": 1}.items() if v}
        if tuple(out.shape) != (2, 2 * ycfg.max_audio_len, ycfg.dims) or err > tol \
                or report["yoho-encode-long"]["collectives"] != want_long:
            raise AssertionError(f"{phase}: yoho_encode_long shape {tuple(out.shape)}, "
                                 f"max abs err {err} (tolerance {tol}), collectives "
                                 f"{report['yoho-encode-long']['collectives']}")
        long = dict(frames=4 * ycfg.max_audio_len, seq=world, max_abs_err=err,
                    tolerance=f"{tol} (1e-4 of the output's largest magnitude, f32)",
                    collectives=report["yoho-encode-long"]["collectives"],
                    wall_s=report["yoho-encode-long"]["wall_s"])
        mel4 = torch.randn((4, ycfg.max_audio_len, ycfg.n_mel_bands), generator=gen,
                           device="cuda")
        with torch.inference_mode():
            ref4 = m32.encode_audio(mel4)
        pipe = pm.init_mesh({"pipe": world})
        out4 = measured("yoho-pipeline", lambda: pipeline_encode(m32, mel4, pipe, 2),
                        want=("flash_attention_forward",))
        err4 = float((out4 - ref4).abs().max())
        tol4 = 1e-4 * max(1.0, float(ref4.abs().max()))
        flash = report["yoho-pipeline"]["launches"]["flash_attention_forward"]
        if err4 > tol4 or flash != 2 * ycfg.n_audio_blocks // world:
            raise AssertionError(f"{phase}: pipeline_encode max abs err {err4} "
                                 f"(tolerance {tol4}), flash launches {flash}")
        pipeline = dict(stages=world, microbatches=2, batch=4, max_abs_err=err4,
                        tolerance=f"{tol4} (1e-4 of the output's largest magnitude, f32)",
                        flash_launches=flash,
                        collectives=report["yoho-pipeline"]["collectives"],
                        wall_s=report["yoho-pipeline"]["wall_s"])
        del m32
        auto_ref = os.environ.get("SMOKE_AUTO_REF")
        turbo_auto = _mesh_auto(phase, world, mesh, auto_ref, measured) \
            if world > 1 and auto_ref else "world 1: not run"
    pm.shutdown()
    if lead:
        emit(phase, world=world, mesh=spec, backend="nccl", card=card, whisper=whisper,
             yoho=yoho, long_encoder=long, pipeline=pipeline, turbo_auto=turbo_auto,
             serving=dict(whisper=serving, yoho=yserving, slots=BATCH,
                          chunk_tokens=SERVE_CHUNK, wall_s=serve_s), launches=total)
    return total


def e2e_mesh(card: str, kernels) -> dict:
    """Phase e2e-mesh at world = the cards present, at most 4: in this
    process at world 1, else one process per card started here with the
    launcher's environment (rank 0 reports). Returns rank 0's launches."""
    import pickle
    import socket

    import torch

    world = min(torch.cuda.device_count(), MESH_MAX_WORLD)
    if world == 1:
        return _mesh_rank(card, kernels, world)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    # e2e-auto's large-v3-turbo directory and rows, for _mesh_auto.
    auto_ref = Path(_AUTO_SHARED["tmp"].name) / "auto_ref.pkl"
    auto_ref.write_bytes(pickle.dumps({k: _AUTO_SHARED[k] for k in ("hf", "rows", "top2")}))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank"],
        env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 SMOKE_AUTO_REF=str(auto_ref)),
        stdout=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        _AUTO_SHARED.pop("tmp").cleanup()
    if any(p.returncode for p in procs):
        raise AssertionError(f"e2e-mesh: ranks exited {[p.returncode for p in procs]}")
    launches = {}
    for line in outs[0].splitlines():
        if line.startswith("mesh-launches "):
            launches = json.loads(line.split(" ", 1)[1])
        else:
            print(line, flush=True)
    return launches


# ------------------------------------------------------------ e2e-mesh-train

MESH_TRAIN_UPDATES, MESH_TRAIN_ACC = 2, 2
# Above world 1 (bf16 autocast, each rank rounding its partial sums): the
# update losses' relative bound, and the bound on the relative error of
# the whole update, |d_mesh - d_plain| / |d_plain| over every leaf (d: the
# leaves after the updates less those before), set between a sound
# 4-card run (0.0048 at 4x1, 0.0058 at 2x2) and one whose gradient
# reduction kept each rank's own gradient (0.59; its losses equal the
# sound run's: update 1 runs at a learning rate of 0); PERF.md, Findings.
MESH_TRAIN_LOSS_RTOL, MESH_TRAIN_UPDATE_RTOL = 1e-4, 0.1


def _train_predicted(cfg, model_axis: int, updates: int, acc: int, decode_steps: int,
                     buckets: int, checkpoints: int) -> dict:
    """The comm layer's collectives of one ``ASRTrainer.run`` over a (data,
    model) mesh (``updates`` x ``acc`` mini-steps, one validation decoding
    ``decode_steps`` steps, ``checkpoints`` checkpoints, the export). A
    layer is cut when the rules cut it (attention by whole KV-head groups,
    the SwiGLU's hidden units, the vocabulary), and a cut layer's
    collectives run on an axis of 1 too. Per training mini-step: forward,
    one all-reduce per cut attention and MLP and the embedding's lookup
    (``sum_over``) and the logits' gather; backward, one all-reduce per
    ``copy_to`` (a cut layer's input: the cross attention's two) and
    nothing for a sum or a gather; one mask count over ``data``. Per
    update: the gradient buckets and the logged loss over ``data``. The
    validation: a forward without gradient (its loss and mask count over
    ``data``), an encode, each decode step's decoder and vocabulary
    collectives, the decoded rows gathered over ``data``. Each checkpoint
    gathers every cut leaf of the parameters and of the three optimizer
    trees, the export every cut leaf of the parameters."""
    le, ld = cfg.n_audio_blocks, cfg.n_text_blocks
    kvh = max(1, cfg.n_audio_heads // 2)
    a = int(cfg.n_audio_heads % model_axis == 0 and kvh % model_axis == 0)
    m = int(int(cfg.dims * 3) % model_axis == 0)
    e = int(16000 % model_axis == 0)
    fwd = le * (a + m) + ld * (2 * a + m) + e
    bwd = le * (a + m) + ld * (3 * a + m) + e
    cut = le * (4 * a + 3 * m) + ld * (8 * a + 3 * m) + e
    steps = updates * acc
    out = {"all_reduce/model": steps * (fwd + bwd) + fwd + le * (a + m)
           + decode_steps * (ld * (2 * a + m) + e),
           "all_gather/model": steps * e + e + decode_steps * e + (4 * checkpoints + 1) * cut,
           "all_reduce/data": steps + updates * (buckets + 1) + 2,
           "all_gather/data": 1}
    return {k: v for k, v in out.items() if v}


class _FixedBatches:
    """A train loader of given global batches (host arrays): each call to
    ``get_prepared_batch`` gives the next one's rows of this rank's ``data``
    shard (all of it without a mesh)."""

    def __init__(self, batches, mesh):
        self.batches, self.mesh, self.i = batches, mesh, 0

    def get_prepared_batch(self):
        from yoho_tpu_torch.parallel.mesh import shard_batch

        batch = self.batches[self.i % len(self.batches)]
        self.i += 1
        return batch if self.mesh is None else shard_batch(self.mesh, batch)

    def skip(self, n):
        self.i += n

    def terminate(self):
        pass


def _mesh_train_setup(tmp: Path) -> dict:
    """The phase's inputs, made once (the ranks read them): a synthetic SRT
    corpus and speakers from the seed, the default session (its 16,000-id
    tokenizer) under the names the runs train in, and the 5 global batches
    of 16 the ASR runs share (4 mini-steps and the validation's train
    batch)."""
    import wave

    import numpy as np

    from yoho_tpu_torch.text.tokenizer import YOHOTokenizer
    from yoho_tpu_torch.train.dataloader import TranscriptionDataloader

    corpus, root = tmp / "corpus", tmp / "sessions"
    _train_corpus(corpus, tracks=4, seconds=60)
    rng = np.random.default_rng(SEED + 30)
    for s in range(8):
        (corpus / "speakers" / f"spk{s}").mkdir(parents=True)
        for c in range(4):
            t = np.arange(48000) / 16000
            clip = 0.3 * np.sin(2 * np.pi * (180 + 70 * s) * t) + 0.01 * rng.standard_normal(48000)
            with wave.open(str(corpus / "speakers" / f"spk{s}" / f"clip{c}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(np.clip(clip * 32768, -32768, 32767).astype("<i2").tobytes())
    edits = (("'./asr_dataset/noisy'", f"'{corpus}'"),
             ("'./asr_dataset/speakers'", f"'{corpus / 'speakers'}'"))
    names = ["plain", "mesh", "mesh-2x2", "stage3"]
    for name in names:
        config, _ = _write_yoho_session(root, name, edits)
    tok = YOHOTokenizer.load(config.weights.tokenizer)
    loader = TranscriptionDataloader((0.0, 0.9), config, tok, batch_size=16, seed=0,
                                     use_multiprocessing=False, warmup_queue=False,
                                     disable_warnings=True)
    batches = [tuple(np.asarray(x) for x in loader.get_batch(i))
               for i in range(MESH_TRAIN_UPDATES * MESH_TRAIN_ACC + 1)]
    return dict(root=root, batches=batches)


def _asr_trainer(root: Path, name: str, batches, mesh):
    """An ``ASRTrainer`` of the default session ``name`` (bf16 autocast,
    batch 16, 2 accumulated, one validation after the 2 updates) on the
    given batches, over ``mesh`` (None: unsharded)."""
    from dataclasses import replace

    import torch

    from yoho_tpu_torch.core.config import load_session_config
    from yoho_tpu_torch.train.trainer import ASRTrainer

    config = load_session_config(name, root)
    hp = replace(config.hyperparameters.transcribe_pretrain,
                 accumulated_batches=MESH_TRAIN_ACC, validation_frequency=MESH_TRAIN_UPDATES)
    trainer = ASRTrainer(config, hp=hp, mesh=mesh, compute_dtype=torch.bfloat16)
    trainer.train_dataloader.terminate()
    trainer.train_dataloader = _FixedBatches(batches, mesh)
    return trainer


def _update_error(trainer, mesh, plain: dict) -> dict:
    """The mesh trainer's leaves after its updates, gathered whole, against
    the unsharded trainer's: each leaf's largest absolute difference, and
    the relative error of the whole update over every leaf (AdamW's first
    steps are nearly ``lr * sign(g)``, so a scale-free norm of the update
    is what tells a lost reduction from rounding). The largest over the
    ranks, so every rank reaches the same verdict."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from yoho_tpu_torch.parallel.mesh import fetch_to_host

    got = fetch_to_host(mesh, trainer._leaves, trainer._specs)
    num = den = worst = 0.0
    worst_at = ""
    for k, want in plain["leaves"].items():
        want = want.numpy().astype(np.float64)
        diff = got[k].astype(np.float64) - want
        num += float((diff * diff).sum())
        den += float(((want - plain["init_leaves"][k].numpy()) ** 2).sum())
        if float(np.abs(diff).max()) > worst:
            worst, worst_at = float(np.abs(diff).max()), k
    out = torch.tensor([(num / den) ** 0.5 if den else float(num > 0), worst],
                       dtype=torch.float64, device="cuda")
    dist.all_reduce(out, op=dist.ReduceOp.MAX)  # not a counted collective
    return dict(update_rel_err=float(out[0]), leaf_max_abs_err=float(out[1]),
                leaf_max_abs_err_at=worst_at, leaves=len(plain["leaves"]))


def _timed_run(trainer, updates: int) -> dict:
    """``trainer.run`` with each mini-step synchronized and timed; the
    update losses, the steps' ms and the peak memory above what was held."""
    import statistics

    import torch

    inner, ms = trainer._train_step, []

    def step(*batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        return out

    trainer._train_step = step
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer.run(max_updates=updates)
    trainer._train_step = inner
    return dict(update_losses=trainer.update_losses, step_ms=ms,
                step_ms_median_after_first=statistics.median(ms[1:]),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                held_before=held)


def _step_pair(phase: str, label: str, model_fn, step_fn, run, mel, tokens, mask) -> dict:
    """A parallel train step's loss and gradients (``run`` times and counts
    the step) against the unsharded step's on this rank's card, in f32:
    loss within 1e-5 and every gradient within 3e-5 (the JAX tests'
    bounds)."""
    import torch

    from yoho_tpu_torch.nn import params as nn_params
    from yoho_tpu_torch.parallel.long_encoder import trained_parameters
    from yoho_tpu_torch.train.trainer import masked_ce_loss

    ref = model_fn()
    named = trained_parameters(ref)
    loss = masked_ce_loss(ref(tokens, mel), tokens, mask)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                allow_unused=True, materialize_grads=True)))
    views = {k: v for k, (_t, v) in nn_params.jax_parameters(ref).items()}
    step = step_fn(model_fn())
    got_loss, got = run(lambda: step(mel, tokens, mask))
    loss_err = abs(float(got_loss) - float(loss.detach()))
    grad_err = max(float((got[k] - views[k](g)).abs().max()) for k, g in grads.items())
    if loss_err > 1e-5 or grad_err > 3e-5:
        raise AssertionError(f"{phase} ({label}): loss error {loss_err}, largest gradient "
                             f"error {grad_err}")
    return dict(loss=float(loss.detach()), loss_abs_err=loss_err, grad_max_abs_err=grad_err,
                tolerance="loss 1e-5, gradients 3e-5 (f32)")


def _mesh_train_rank(card: str, kernels, world: int, tmp: Path, plain: dict) -> dict:
    """One rank of phase e2e-mesh-train (the module doc, item 16); rank 0
    prints the phase's line. Returns this rank's launches on the mesh
    runs."""
    from dataclasses import replace

    import numpy as np
    import torch

    from yoho_tpu_torch.core.config import load_session_config
    from yoho_tpu_torch.dryrun import dryrun_multichip
    from yoho_tpu_torch.nn.params import init_random
    from yoho_tpu_torch.nn.yoho import YOHOModel
    from yoho_tpu_torch.parallel import mesh as pm
    from yoho_tpu_torch.parallel.long_encoder import make_long_context_train_step
    from yoho_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from yoho_tpu_torch.train.sharded_checkpoint import (
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )
    from yoho_tpu_torch.train.stages.stage3_voiceprint import VoiceprintTrainer

    phase = "e2e-mesh-train"
    lead = int(os.environ.get("RANK", 0)) == 0
    measured, total, report = _part_counter(phase, kernels)
    root = tmp / "sessions"
    batches = plain["batches"]
    line = dict(world=world, backend="nccl", card=card)

    specs = [f"{world}x1"] + (["2x2"] if world == 4 else [])
    asr = {}
    for spec, name in zip(specs, ("mesh", "mesh-2x2")):
        mesh = pm.parse_mesh(spec)
        trainer = _asr_trainer(root, name, batches, mesh)
        pm.reset_counts()
        run = measured(f"asr-{spec}", lambda: _timed_run(trainer, MESH_TRAIN_UPDATES))
        counts = dict(pm.COUNTS)
        cfg = trainer.config.yoho
        steps = _decode_launches(report[f"asr-{spec}"]["launches"]) // (2 * cfg.n_text_blocks)
        buckets = len(list(pm._buckets(list(trainer._leaves.values()), pm.BUCKET_ELEMENTS)))
        predicted = _train_predicted(cfg, mesh.shape["model"], MESH_TRAIN_UPDATES,
                                     MESH_TRAIN_ACC, steps, buckets, checkpoints=2)
        if counts != predicted:
            raise AssertionError(f"{phase} ({spec}): collectives {counts}, predicted "
                                 f"{predicted}")
        losses, want = run["update_losses"], plain["update_losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        equal_leaves = update = None
        if world == 1:
            equal_leaves = all(torch.equal(a, plain["leaves"][k])
                               for k, a in trainer._leaves.items())
            if losses != want or not equal_leaves:
                raise AssertionError(f"{phase} ({spec}): at world 1 the mesh trainer's update "
                                     f"losses {losses} (unsharded {want}), every leaf equal: "
                                     f"{equal_leaves}")
        else:
            update = _update_error(trainer, mesh, plain)
            if not all(np.isfinite(losses)) or rel > MESH_TRAIN_LOSS_RTOL \
                    or not update["update_rel_err"] <= MESH_TRAIN_UPDATE_RTOL:
                raise AssertionError(f"{phase} ({spec}): update losses {losses}, unsharded "
                                     f"{want}; leaves against the unsharded ones {update}")
        asr[spec] = dict(run, unsharded_update_losses=want, loss_max_rel_err=rel,
                         loss_bound=f"bit-equal at world 1; {MESH_TRAIN_LOSS_RTOL} relative "
                                    "above (bf16: each rank rounds its partial sums)",
                         leaves_bit_equal=equal_leaves, leaves_against_unsharded=update,
                         update_bound=None if update is None else MESH_TRAIN_UPDATE_RTOL,
                         collectives=counts, predicted=predicted,
                         decode_steps=steps, gradient_buckets=buckets,
                         unsharded_step_ms=plain["step_ms"],
                         unsharded_step_ms_median_after_first=plain["step_ms_median"],
                         unsharded_max_memory_allocated=plain["max_memory_allocated"],
                         unsharded_held_before=plain["held_before"],
                         launches=report[f"asr-{spec}"]["launches"])
        if spec == specs[0]:
            # The sharded checkpoint of this trainer's state: an exact round trip.
            ospecs = trainer._state_specs()

            def zeros(tree):
                return {k: zeros(v) if isinstance(v, dict) else
                        (torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0)
                        for k, v in tree.items()}

            def same(a, b):
                if isinstance(a, dict):
                    return all(same(a[k], b[k]) for k in a)
                return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

            t0 = time.perf_counter()
            path = tmp / "dcp" / "ckpt"
            save_checkpoint_sharded(path, trainer.step, trainer._leaves, trainer.opt_state,
                                    mesh, trainer._specs, ospecs)
            saved = time.perf_counter() - t0
            got = load_checkpoint_sharded(path, zeros(trainer._leaves), zeros(trainer.opt_state),
                                          mesh, trainer._specs, ospecs)
            exact = got is not None and got[0] == trainer.step and same(trainer._leaves, got[1]) \
                and same(trainer.opt_state, got[2])
            if not exact:
                raise AssertionError(f"{phase}: the sharded checkpoint's round trip is not exact")
            line["sharded_checkpoint"] = dict(bit_equal=exact, save_s=saved,
                                              files=sorted(p.name for p in path.iterdir()))
        del trainer
        torch.cuda.empty_cache()
    line["asr"] = asr

    # Stage 3 (NT-Xent over the global batch) for one update.
    mesh = pm.parse_mesh(specs[0])
    config = load_session_config("stage3", root)
    hp3 = replace(config.hyperparameters.voiceprint_finetune, accumulated_batches=MESH_TRAIN_ACC)
    config.hyperparameters = replace(config.hyperparameters, voiceprint_finetune=hp3)
    stage3 = VoiceprintTrainer(config, mesh=mesh, compute_dtype=torch.bfloat16)
    pm.reset_counts()
    run3 = measured("stage3", lambda: _timed_run(stage3, 1), want=YOHO_PATH[:2])
    counts3 = dict(pm.COUNTS)
    if counts3.get("all_gather/data") != 2 * MESH_TRAIN_ACC \
            or not np.isfinite(run3["update_losses"]).all():
        raise AssertionError(f"{phase} (stage 3): collectives {counts3}, losses "
                             f"{run3['update_losses']}")
    line["stage3"] = dict(run3, collectives=counts3,
                          nt_xent="embeddings and speaker ids gathered over data each "
                                  "mini-step, the gradient summed before each rank keeps its rows")
    del stage3

    # The long-context and GPipe steps in f32 against the unsharded step.
    cfg = load_session_config("plain", root).yoho
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    vocab = 16000

    def model_fn():
        return init_random(YOHOModel(cfg, vocab, dtype=torch.float32), seed=SEED)

    def batch(rows, frames, text):
        mel = torch.randn((rows, frames, cfg.n_mel_bands), generator=gen, device="cuda")
        tokens = torch.randint(0, vocab, (rows, text), generator=gen, device="cuda")
        mask = (torch.rand((rows, text), generator=gen, device="cuda") < 0.7).to(torch.uint8)
        return mel, tokens, mask

    flash = ("flash_attention_forward",)  # the stem and decoder's, outside the ring
    seq = pm.init_mesh({"seq": world})

    def counted(label):
        def run(fn):
            pm.reset_counts()
            out = measured(label, fn, want=flash)
            report[label]["collectives"] = dict(pm.COUNTS)
            return out
        return run

    line["long_context"] = dict(_step_pair(
        phase, "long-context", model_fn, lambda m: make_long_context_train_step(m, seq),
        counted("long-context"), *batch(2, 2 * cfg.max_audio_len, cfg.max_text_len)),
        seq=world, frames=2 * cfg.max_audio_len,
        collectives=report["long-context"]["collectives"])
    pipe = pm.init_mesh({"pipe": world})
    line["pipeline"] = dict(_step_pair(
        phase, "gpipe", model_fn, lambda m: make_pipeline_train_step(m, pipe, 2),
        counted("gpipe"), *batch(4, cfg.max_audio_len, cfg.max_text_len)),
        stages=world, microbatches=2, collectives=report["gpipe"]["collectives"])

    # The dry run of every mesh program.
    line["dryrun"] = measured("dryrun", lambda: dryrun_multichip(world))
    line["walls_s"] = {k: v["wall_s"] for k, v in report.items()}
    line["launches"] = total
    pm.shutdown()
    if lead:
        emit(phase, **line)
    return total


def _mesh_train_plain(tmp: Path, setup: dict) -> dict:
    """The unsharded ``ASRTrainer`` on the phase's batches (this process, no
    group): its update losses, mini-step ms and leaves before and after."""
    import statistics

    trainer = _asr_trainer(setup["root"], "plain", setup["batches"], None)
    init = {k: v.detach().clone() for k, v in trainer._leaves.items()}
    run = _timed_run(trainer, MESH_TRAIN_UPDATES)
    leaves = {k: v.detach().clone() for k, v in trainer._leaves.items()}
    return dict(update_losses=run["update_losses"], step_ms=run["step_ms"],
                step_ms_median=statistics.median(run["step_ms"][1:]), leaves=leaves,
                init_leaves=init,
                max_memory_allocated=run["max_memory_allocated"],
                held_before=run["held_before"], batches=setup["batches"])


def e2e_mesh_train(card: str, kernels) -> dict:
    """Phase e2e-mesh-train at world = the cards present, at most 4: the
    inputs and the unsharded trainer's run here, then the mesh runs in this
    process at world 1, else one process per card started with the
    launcher's environment (rank 0 reports). Returns rank 0's launches."""
    import pickle
    import socket
    import tempfile

    import torch

    world = min(torch.cuda.device_count(), MESH_MAX_WORLD)
    with tempfile.TemporaryDirectory(prefix="yoho_mesh_train_smoke_") as tmp:
        tmp = Path(tmp)
        setup = _mesh_train_setup(tmp)
        plain = _mesh_train_plain(tmp, setup)
        if world == 1:
            return _mesh_train_rank(card, kernels, world, tmp, plain)
        for key in ("leaves", "init_leaves"):  # to the host, for the ranks
            plain[key] = {k: v.cpu() for k, v in plain[key].items()}
        (tmp / "plain.pkl").write_bytes(pickle.dumps(plain))
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-train-rank", str(tmp)],
            env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                     LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if any(p.returncode for p in procs):
            raise AssertionError(f"e2e-mesh-train: ranks exited {[p.returncode for p in procs]}")
    launches = {}
    for line in outs[0].splitlines():
        if line.startswith("mesh-launches "):
            launches = json.loads(line.split(" ", 1)[1])
        else:
            print(line, flush=True)
    return launches


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "yoho_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: no yoho_tpu_torch package beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))

    card = card_line()
    if "--mesh-rank" in argv or "--mesh-train-rank" in argv:  # one rank of a mesh phase
        import pickle

        from yoho_tpu_torch.ops import decode_attention, flash_attention, mel_kernel, w8a8_dense

        kernels = [mel_kernel.KERNEL, flash_attention.KERNEL, *decode_attention.KERNELS,
                   w8a8_dense.KERNEL]
        world = int(os.environ["WORLD_SIZE"])
        if "--mesh-rank" in argv:
            launches = _mesh_rank(card, kernels, world)
        else:
            tmp = Path(argv[argv.index("--mesh-train-rank") + 1])
            launches = _mesh_train_rank(card, kernels, world, tmp,
                                        pickle.loads((tmp / "plain.pkl").read_bytes()))
        print("mesh-launches " + json.dumps(launches), flush=True)
        return 0
    print(card, flush=True)  # name and power limit, as nvidia-smi prints them
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    from yoho_tpu_torch.ops import _build
    from yoho_tpu_torch.ops import decode_attention, flash_attention, mel_kernel, w8a8_dense

    t0 = time.perf_counter()
    per_source = _build.build()
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source,
         flash_attention_cu_s=per_source.get("flash_attention.cu"))

    kernels = [mel_kernel.KERNEL, flash_attention.KERNEL, *decode_attention.KERNELS,
               w8a8_dense.KERNEL]
    entries = kernel_checks(card)
    launches = {k.name: 0 for k in kernels}
    for path in PATHS:
        for name, n in e2e(card, kernels, *path, trace="--profile" in argv).items():
            launches[name] += n
    for name, n in e2e_options(card, kernels, trace="--profile" in argv).items():
        launches[name] += n
    for phase in (e2e_files, e2e_spec, e2e_serve, train_phase, e2e_cli, e2e_yoho, e2e_auto,
                  e2e_yoho_train, e2e_mesh, e2e_mesh_train, e2e_wide_heads):
        kw = {"trace": "--profile" in argv} if phase is e2e_yoho_train else {}
        t0 = time.perf_counter()
        for name, n in phase(card, kernels, **kw).items():
            launches[name] += n
        emit("phase-wall", path=phase.__name__.replace("_", "-"),
             seconds=time.perf_counter() - t0)
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the paths: {idle}")
    print(json.dumps({"kernels": [
        dict(entries[k.name], launches=launches[k.name]) for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
