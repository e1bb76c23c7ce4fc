#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # the full check, on one card

Phases, each of which exits non-zero on a failed check:

  1. the card's name and power limit, as ``nvidia-smi`` reports them;
  2. the ``nvcc`` builds of ``src/repro_torch/kernels/csrc/zstats.cu`` and
     ``csrc/flash_attention.cu``, started together, with what ``-Xptxas
     -v`` says of each kernel (registers, spills) and the wgmma flash
     kernel's dynamic shared memory;
  3. every kernel (CUDA ``zstats``, ``zstats_zmap`` and ``zmap_logits``,
     Triton ``dirichlet_expectation`` and ``zstep``) against its plain
     PyTorch version on the card: the edge cases of the reference's kernel
     tests rebuilt from numpy seeds (K = 3, 130 and 2, strided with base,
     masked, several children, the V = 33,000 child, the G = 70,000 prior,
     and K = 100, 64 and 96 with masks, a strided child and long keys;
     for segment latents its ZMAP_KERNEL_CASES, its alpha "zmap" case, two
     zmap children, an unsorted zmap, an empty and an all-masked instance,
     instances of more than PIECE tokens, K = 1024), elog and alpha tables,
     bf16 tables, and each path's shapes; strided children on their
     passes: DCM-LDA layouts at K = 16 on the "runs" pass (a hot word, one
     (document, word) run of 1,500 tokens, masks), ``strided-base`` on the
     per-column "strided" pass; two launches of each pass bitwise; segment
     latents' phase 2b on DCM-SLDA layouts (ZMAP_RUNS_CASES: a hot word, a
     run of 1,500 tokens, masks with fractions, an empty and an all-masked
     sentence, K = 100) on the "runs" pass, each twice bitwise and bitwise
     the per-column "strided" pass at the same inputs, and ``zmap-strided``
     (colliding rows) on the per-column pass;
  4. repeatability: two ``zstats`` calls, and two 3-step runs from one
     state, must be bitwise equal;
  5. the main path: LDA at the NYTimes bag-of-words widths (K = 100,
     V = 102,660, alpha = 0.1, beta = 0.05) over a planted corpus of 30,000
     documents of mean length 332 (about 10M tokens), through
     ``models.make`` -> ``observe`` -> ``Model.infer(steps=10)`` ->
     ``get_result``, with the launch counts set to 0 just before and read
     just after; ``explain_plan(backend="cuda")`` of the model names the
     route that the steps' launches took (``ops.route_counts``), as it does
     for SLDA, naive Bayes and ``lda_svi`` (whose plan's caps are batch
     0's);
  6. times (CUDA events) of each kernel, its plain version and its bound at
     the main path's shapes (the Elog pass on phi also by its two Triton
     launches, row sums and elementwise), and the VMP step's ms and
     tokens/s;
  7. SVI (``core/svi.py``) over the main path's program, run after phase 6
     while it exists, with Hoffman et al.'s defaults (batches of 1,024
     documents, kappa 0.7, tau 10, padding to 256, 5% held out, evaluated
     every 10 steps with 10 local passes): one step at |B| = G, exact caps
     and rho = 1 bitwise one VMP step; a batch padded to 256 within 2e-5 of
     it at exact caps (the masked kernel route against the unmasked one);
     the documents outside a batch keep their theta rows bitwise; two
     5-step runs bitwise; the 30-step fit (launch counts set to 0 just
     before and read just after: ``zstats`` once a step and 11 times an
     evaluation), every ELBO finite and the held-out ELBO rising;
     ``zstats`` (masked) and the Elog pass at one batch's inputs against
     their plain versions; per step the host clock, tokens/s, and inside
     the same steps the ``slice_arrays``, owner-plan and host-to-device ms,
     device ms and idle share under the profiler, and the held-out
     evaluation's ms.  SLDA and naive Bayes (after their VMP phases) each
     hold batch 0 padded against exact caps within 2e-5 and run 5 padded
     SVI steps with a held-out evaluation through ``zstats_zmap`` (launch
     counts set to 0 just before and read just after), then hold
     ``zstats_zmap`` and ``zmap_logits`` against their plain versions at
     one padded batch's inputs; naive Bayes first holds one step at
     |B| = G bitwise against VMP.  Then the ``lda_ooc`` phase, while the
     main path's corpus exists: the corpus written to disk shards in a
     temporary directory (removed at exit) and streamed through
     ``SVI(sharded_template(...), corpus=, prefetch=True)``, whose slice
     (``slice_sharded``) and owner plans are built on the prefetch thread:
     the 30-step fit bitwise ``lda_svi``'s (its digest), the peak host
     buffers and shard bytes read, per step the host clock, tokens/s, the
     thread's slice and plan ms, the caller's wait and copy ms, device ms
     and idle share beside ``lda_svi``'s; 20 steps with a session every 5
     crashed by ``svi.step=raise@13`` and resumed, and run by a child
     process armed with ``REPRO_FAULTS="svi.step=kill@13"`` (it must die
     by SIGKILL), resumed here: both bitwise the uninterrupted 20 steps; a
     growing corpus (the first 20,000 documents, the rest appended after
     step 10): the population rises at the next epoch boundary, every ELBO
     finite, the held-out documents' theta rows untouched, and a crash at
     step 27 resumed bitwise; ``run_inference`` with checkpoints, half the
     main path's steps and a resume for the rest, bitwise its digest;
     ``zstats`` and the Elog pass at one out-of-core batch.  Between them
     the ``query`` phase: ``lda_svi``'s final state frozen
     (``InferenceResult.freeze``), saved and loaded bitwise; ``FoldIn`` of
     its 1,500 held-out documents at exact caps bitwise
     ``svi.heldout_elbo``, its per-document LL summing to the ELBO and its
     mixtures to 1 within 1e-5, two scores bitwise; a ``QueryServer``
     (batches of up to 64 documents, ``pow2`` buckets) answering 256
     requests of 1-4 held-out documents from 8 ``QueryClient`` threads
     (launch counts set to 0 just before the fold-in and read after the
     server stops), each response within 1e-5 of its documents scored
     alone, a multi-document request bitwise its direct score, ``stats()``
     counting every request; one ``credible_interval`` row within 1e-12
     of ``scipy.special.betaincinv``; a 64-document score cold and warm,
     split into host parts (``FoldIn.times``) and device time and idle
     share under the profiler; ``zstats``, the Elog pass and ``zstep``
     against their plain versions at the inputs that the held-out fold-in
     and a warm 64-document score handed them (recorded as they ran).
     Then the ``gateway`` phase (``benchmarks/bench_gateway.py``'s
     protocol): the frozen posterior and a replica compacted at top-k 128
     (bitwise across save/load, its tables on the card bitwise the host's
     compaction) under one ``Gateway``; 4 tenant threads each running the
     bench's script (TOPICS, SIMILARITY, CREDIBLE INTERVAL on a theta row,
     PREDICT of 3 corpus documents) once on each artifact, launch counts
     set to 0 just before and read just after; every PREDICT within 1e-5
     of ``FoldIn.score`` alone, ``stats()`` counting every query and no
     error; queries/s and p95, ms per query kind full against lite, bytes,
     ``error_bound`` and the replicas' PREDICT deviation, one phi-row
     interval; EXPLAIN's route the executed one for every kind, its kernel
     routes those the launches took; ``zstats``, the Elog pass and
     ``zstep`` at one PREDICT's recorded inputs (entry ``gateway``).
     After ``lda_ooc`` the ``gibbs`` phase: ``make_engine("gibbs",
     steps=40, holdout_frac=0.05)`` on the main path's model, then
     ``gibbs_lda`` on the engine's training tokens with every sweep's
     counts checked against them, and once more alone for ms a sweep,
     tokens/s and peak memory, the three chains bitwise; the complete-data
     LL rising past burn-in, the held-out ELBO (fold-in of lda_svi's
     held-out documents) finite, ``aligned_tv`` beside the SVI fit's; the
     held-out scoring's kernels against their plain versions at its own
     inputs.  After ``gibbs`` the ``lda_dist`` phase, the distributed path
     at the main path's widths: full-batch VMP under
     ``ShardingPlan(2, "inferspark")`` (both shards in this process) from
     the main path's initial state, 5 steps within 1e-4 of as many
     one-device steps (the ELBO trace, the gathered phi and theta), two
     runs bitwise, each step handing the shard group phi's stats and the
     ELBO and nothing of theta, the owner plans' ms per shard, one step
     under the profiler; then SVI at ``lda_svi``'s settings over the
     corpus in disk shards of 2^20 tokens (both hosts must own some), 10
     steps each: the plain 2-shard plan path, ``hosts=HostAssignment(1,
     0)`` bitwise it, 2 virtual hosts within 5e-4 of it, two child
     processes on the card (one gloo rank each, each opening the corpus
     through its own host view, through ``multihost_svi_session``) bitwise
     the 2-virtual-host run with phi's bytes over the wire
     ``collective_bytes_per_iteration`` a step, that run with sessions every 2 steps in a
     child armed with ``svi.step=kill@6`` (it must die by SIGKILL),
     resumed here bitwise; ms a step, the group's ms
     and the bytes handed to it a step, each host's owned disk bytes, one step under the
     profiler; ``zstats`` and the Elog pass at one shard's inputs of each
     (entries ``lda_dist`` and ``lda_multihost``), recorded as they ran.
     The ``gateway`` phase also holds each PREDICT's ``FoldIn.score``
     ELBO to the sum of its documents' LL within 1e-5 of it;
  8. the segment-latent path: SLDA at the same widths over the same corpus,
     cut into sentences of 7 tokens (about 1.44M sentences), through
     ``models.make("slda")`` -> ``observe`` + ``bind("sents")`` ->
     ``make_engine("vmp", steps=10).fit`` -> ``get_result("z")``, with the
     same checks and two bitwise repeats; then naive Bayes at the 20
     Newsgroups widths (C = 20, V = 61,188, 18,774 documents of mean length
     332), 5 steps, the same checks.  On each path every kernel it runs
     (``zstats_zmap``, ``zmap_logits``, ``dirichlet_expectation``,
     ``zstep``) is held against its plain version on the path's own inputs
     and timed beside its bound, with the path's launch counts;
     after ``slda_svi`` the ``slda_query`` phase: its fit frozen, payload A
     then B (four held-out documents each, cut into sentences, with
     ``bindings={"sents": ...}``) folded in on one ``FoldIn``, B warm in
     A's bucket bitwise B on a cold ``FoldIn``, ``zstats_zmap`` and
     ``zmap_logits`` against their plain versions at the inputs that B's
     warm score handed them; A and B as PREDICT with bindings through a
     ``Gateway``, bitwise the phase's scores, EXPLAIN naming ``zmap`` with
     the ``group`` logits, the route the launches took;
  9. both ``flash_attention`` kernels against ``ref.flash_attention``: the
     reference's FLASH_SHAPES, Sq != Sk, a non-causal ragged Sk, Dh = 80 and
     256, ragged and multi-tile cases at Dh 64 and 128, gemma3-4b's global
     layer at Dh 256 ((8, 4,096) and (32, 2,048)), and the trainer's
     shape (BH = 64, S = 2,048, Dh = 128), each in bf16 and f32 through the
     route ``flash_attention.route`` gives it (checked), the bf16 cases at
     Dh 64, 128 and 256 also through the ``mma`` route; two launches of
     each route bitwise; the autograd Function's gradients bitwise those of
     the plain version for one cotangent; both routes timed in turns beside
     the bound, the plain version's and SDPA's (a yardstick the port never
     calls) at the trainer's shape and at both Dh-256 shapes, where the
     wgmma route must beat the mma route;
  10. the LM trainer: olmo-1b at full width and depth through
     ``launch.train.train`` (4 steps, batch 4 x 2,048 tokens, bf16 compute,
     f32 parameters from the port's own initialisation, attention through
     the kernel), with the kernel's launch count set to 0 just before and
     read just after (16 layers x 4 forwards, all on the wgmma route),
     step 0's loss at the chance level of the model's own initial logits
     and every loss finite and within 1.5 nats of it, every parameter moved, flash against dense attention on one batch,
     ms per step, tokens/s, the model flops' share of the bf16 peak, peak
     memory, and the device's idle share over 2 steps under the profiler;
  11. serving (``lm_serve``): olmo-1b (batch 8) and gemma3-4b (batch 4,
     LLLLLG with window 1,024) at full width and depth through
     ``launch.serve.serve``, prompts of 4,096 tokens, 64 new tokens, bf16
     compute: the prefill's chunked routes (``_sdpa_flash`` with the causal
     skip, ``_sdpa_window``), no kernel launched, prefill ms, decode ms a
     step, tokens/s, peak memory, a decode step twice from one cache
     bitwise, and 8 decode steps under the profiler; then in f32 at batch
     2, 8 teacher-forced decode steps after a chunked prefill of 1,024
     tokens and one of 32 (local windows cut to 16) against prefill of the
     growing prefix (gemma3's rings wrap), each with a power control (the
     first step with one key zeroed must leave the tolerance), and olmo-1b's greedy ``serve`` against prefill's argmax over
     the growing sequence at both lengths; gemma3-4b's training step at one block cycle,
     batch 1 x 4,096, its global layer through the flash kernel's wgmma
     route (Dh 256, launches counted), the loss against the plain path's,
     the kernel timed at the inputs the path handed it (both routes in
     turns); and olmo-1b at 2
     layers trained 4 steps straight against 2 saved and 2 resumed through
     ``train``'s checkpoints;
  12. DCM-LDA (``dcmlda``, run after naive Bayes' phases):
     ``benchmarks/bench_vmp.py``'s settings (K = 16, V = 2,000, the repo's
     priors, mean length 120) at 10,000 documents (about 1.2M tokens, phi
     on 160,000 docs x topics rows), 10 steps through ``Model.infer`` and
     ``get_result``: ``zstats`` once a step with phi's stats on the "runs"
     pass (the route ``explain_plan(backend="cuda")`` names), the ELBO
     monotone, the stats
     sums, the digest, the kernels at the inputs the last step and
     ``get_result`` handed them (the Elog pass on phi timed too), ms a step
     and device time; then DCM-SLDA (``dcmslda``): SLDA's sentence topics
     over DCM-LDA's per-document phi (``models.make("dcmslda")``), over
     the same corpus cut into sentences of SENT_LEN tokens, 10 steps through
     ``Model.infer`` and ``get_result``: ``zstats_zmap`` once a step with
     phi's phase 2b on the "runs" pass (route ``zmap passes=runs
     logits=group``, the one ``explain_plan`` names), the ELBO monotone,
     theta's stats summing to the sentences and phi's to N, q(z) rows to
     1, the digest; at the last step's inputs ``zstats_zmap`` against its
     plain version, twice bitwise and bitwise the per-column pass, both
     timed (the call, and phase 2b alone and its zero fill, CUDA events)
     beside their bounds; ``zmap_logits``, ``zstep`` and the Elog passes at
     the inputs handed them; ms a step and device time; then the Dirichlet
     terms (``dirichlet_terms``): the ELBO term and the update at the
     benchmark's tables (dcmlda-nips' phi, lda-nytimes' phi through its
     transposed Elog table and its theta), the ELBO term within
     ``dirichlet_terms.error_limit`` (set by the plain f32 version's own
     error) and DIRICHLET_TOL of an f64 evaluation and exactly 0 on a
     table that is all prior, each kernel twice bitwise and the update
     bitwise ``prior * ones + stats``, each timed beside its plain version
     and its bound (the same checks run on the largest Dirichlet table of
     each VMP path: lda, lda_svi, slda, naive_bayes, dcmlda, dcmslda);
  13. experts (``lm_moe``, after ``lm_serve``): qwen3-moe-30b-a3b at full
     width and 8 of its 48 layers through ``serve`` (8 x 4,096, 64 new
     tokens, bf16: prefill, decode, tokens/s, the decode profile, peak
     memory, a decode step twice bitwise, the share of dropped
     assignments in a prefill and a decode step at the default capacity);
     qwen3-moe and moonshot-v1-16b-a3b at 2 layers in f32: decode against
     prefill of the growing prefix at ``moe_capacity = E/k`` with the
     zeroed-key control, and at the default capacity every layer's
     routing arrays (``take``, ``w_slot``) in one prefill and one decode
     call against a host recomputation from the same router logits;
     qwen3-moe training at 2 layers, 4 x 2,048 tokens, through
     ``train`` and the flash kernel (wgmma, launches counted): the plain
     run twice, remat full and dots bitwise it, microbatch 2 (its first
     loss bitwise its halves' composition and within 1e-4 nats of the
     plain one), ms a step, tokens/s and peak memory of each, the kernel
     at the inputs the path handed it; and a MoE trainer (16 experts,
     one layer, vocabulary 16,384) checkpointed and resumed bitwise;
  14. recurrent layers (``lm_recurrent``, after ``lm_moe``):
     recurrentgemma-2b (26 layers, RG-LRU and local attention) and
     mamba2-370m (48 SSD layers) at full width and depth through
     ``serve`` (8 x 4,096, 64 new tokens, bf16: prefill first and warm,
     decode ms a step, tokens/s, the decode profile and its launches a
     step, peak memory, a decode step twice bitwise), each one's first
     recurrent layer alone at 8 x 4,096 (the RG-LRU's scan apart); at full
     width and reduced depth in f32 (recurrentgemma one cycle and its
     2-layer tail, mamba2 2 layers), at the initialisation's weights and
     at a long-memory edit of ``lam`` and ``dt_bias``: a 1,024-token
     prefill and a decode step each twice bitwise, 128 teacher-forced
     decode steps against one training forward within 2e-3, and at long
     memory a zeroed ``h`` and a zeroed ``conv`` state that must leave
     it; training at 4 x 2,048 (mamba2 at 24 layers, plain and
     ``remat="full"`` bitwise it; recurrentgemma at 8 layers), step 0's
     loss and every gradient finite, ms a step, tokens/s, peak memory.
     No kernel of the port is on this path; the phase's launch counts
     stay 0;
  15. the encoder and the frontends (``lm_encoder``, after
     ``lm_recurrent``): whisper-large-v3 (32 encoder and 32 decoder
     layers, layernorm, gelu; 8 streams of 1,500 frames stubbed as
     embeddings, a 4-token start-of-transcript prompt) and internvl2-1b
     (24 layers; 8 x (256 patches + 3,840 tokens)) at full width and depth
     through ``build_prefill_step`` and ``build_decode_step`` (``serve``
     takes tokens only), 64 greedy tokens, bf16: prefill first and warm
     (whisper's encoder alone too), decode ms a step, tokens/s, the decode
     profile and its launches a step, peak memory, a decode step twice
     bitwise, no kernel launched; in f32 at full width and reduced depth
     (whisper 2 + 2 layers, internvl2 2 layers, batch 2): the prefill's
     logits against the training forward's (the reference's prefill
     skips the encoder), 32 teacher-forced decode steps against the
     training forward within 2e-3, and controls that must leave it (one
     layer's cross K zeroed, one key zeroed in every layer, the frames or
     patches zeroed); training at full depth through ``build_train_step``
     with the flash kernel (internvl2 4 x (256 + 1,792), whisper 3 x
     (1,500 frames + 448 tokens)), 8 steps: the decoder's launches all on
     the wgmma route at Dh 64, step 0's loss at the chance level of its
     logits, every loss and gradient norm finite, the median step,
     tokens/s and peak memory, the kernel at the inputs the path handed
     it against its plain version, the mma route and SDPA (entries
     ``lm_whisper_train``, ``lm_internvl_train``);
  16. LM sharding (``lm_shard``, after ``lm_encoder``): olmo-1b at full
     width and depth on a (2 data x 2 model) mesh of virtual shards with
     FSDP through ``train(mesh=)``, lm_train's batch and settings, 3 steps
     each within LM_LOSS_TOL of lm_train's one-device loss, flash launched
     once a layer, shard and step at the shard's shape (2 rows x 8 heads),
     ms a step beside one device's, the shard group's payload a step by
     key, peak memory, the kernel at the shard's inputs against its plain
     version, the mma route and SDPA (entry ``lm_shard``); the elastic
     re-mesh: olmo-1b at 2 layers checkpointed after 2 steps on (2, 2),
     the restored tree bitwise the shards' slices gathered, step 2 resumed
     on ``factor_mesh(2, want_model=2)`` = (1, 2) and on one device within
     LM_LOSS_TOL of (2, 2)'s; qwen3-moe at lm_moe's training settings on
     (1, 2), 64 experts a shard, 2 steps within LM_LOSS_TOL of lm_moe's one
     device; two gloo processes on the card, each one shard of (1, 2) at
     olmo-1b's full width and 2 layers, 2 steps bitwise this process
     running both (a digest of every leaf and the losses), wire bytes and
     seconds a step; olmo-1b served in f32 at full width and depth through
     ``serve(mesh=)``, 8 streams on (1, 2) (the cache's heads over model)
     and one on (2, 1) (its sequence over data), 512 + 32 tokens: the
     greedy tokens equal one device's, prefill and decode times beside
     one device's.

Each VMP path, and the SVI fit, logs a sha256 of its final posteriors and
ELBO trace, so that two trees can be shown to give the same output bit for
bit.

The last two lines are a ``{"kernels": [...]}`` JSON object (one entry per
kernel and path, the path named in ``"path"``: lda, lda_svi, query,
gateway, lda_ooc, gibbs, lda_dist, lda_multihost, slda, slda_svi,
slda_query, naive_bayes, naive_bayes_svi, dcmlda, dcmslda,
dirichlet_terms, lm_train, lm_train_gemma3, lm_moe_train, lm_whisper_train,
lm_internvl_train, lm_shard; the ``dirichlet_terms`` entries name their
benchmark table in ``"table"``; the
flash entries' ``"variant"`` names the kernel the path took and
``"mma_ms"`` is the other one's time in the same call; each
``dirichlet_expectation``, ``dirichlet_elbo_term`` and ``dirichlet_update``
entry's ``"device_ms"`` is its time inside a CUDA graph, where ``"ms"``, CUDA events around back-to-back calls, times the
host's launches of so small a kernel) and the
``{"ok": true, "device": {...}}`` JSON object.  A fuller report goes to
``chiprun_out/chip_smoke.json``.  The script imports the port only, never
JAX nor the JAX package.
"""

import argparse
import contextlib
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


# the main path: LDA at the UCI NYTimes bag-of-words widths and the repo's
# LDA priors (examples/lda_topics.py), depth cut from 300,000 documents
TOPICS, VOCAB, MEAN_LEN, ALPHA, BETA, SEED = 100, 102660, 332, 0.1, 0.05, 0
REPORT = ROOT / "chiprun_out" / "chip_smoke.json"
# SLDA over the main path's corpus: sentences of 7 tokens inside each
# document (benchmarks/bench_vmp.py's convention)
SENT_LEN = 7
# naive Bayes at the 20 Newsgroups "bydate" widths (20 classes, 61,188
# words, 18,774 documents), the main path's priors and mean length
NB_CLASSES, NB_VOCAB, NB_DOCS, NB_STEPS = 20, 61188, 18774, 5
# the route each VMP path takes on the card (``ops.route_label``): LDA's flat
# passes; SLDA's sentences of 7 tokens, one piece an instance; naive Bayes'
# documents, many longer than a piece (PIECE = 256 tokens); DCM-LDA's phi
# on docs x topics rows (base doc * K, stride 1: one row for each (base,
# k)), a lane group for each (document, word) run; DCM-SLDA's sentences
# over the same phi, phase 2b a lane group for each (document, word) run
EXPECTED_ROUTE = {"main": "flat passes=pieces",
                  "slda": "zmap passes=pieces logits=group",
                  "naive_bayes": "zmap passes=pieces logits=warp",
                  "dcmlda": "flat passes=runs",
                  "dcmslda": "zmap passes=runs logits=group"}
# each path's sha256 at full depth: the posteriors are those of commit
# 4685efb's run (dcmslda's of its first run of the "runs" phase 2b), the
# ELBO traces those of the Dirichlet ELBO-term kernel (rows summed in f64),
# which sums in another order than the plain version; a documented change
# of a sum's order changes one, and the log says which
KNOWN_DIGESTS = {
    "main": "2c35a6036dceeb3f0d7751a572301b0511ba7f958e9862c2c5af2ddb295ba755",
    "slda": "4413815808e73583029e8d374bbc14f89642fb35d334eaae2fb58f8ea7165872",
    "naive_bayes":
        "e213215ef084155533acd8906fbdcf0ae43d61abcccf45be2f1af8d4d93044f3",
    "lda_svi":
        "361d458cf9ff33efc9feb67af093c1e58077bf770e8e79bee064a7da9cedab7e",
    "dcmlda": "10ce50eb743dc1dfab2d93ccc97482d67f8d9fddb37e537bf96bca3047a1fa4b",
    "dcmslda":
        "41fba3c9f2db7d90192e60622a6c11a548161fb4deadd736a3bc32725c753843",
}

ZSTATS_TOL = dict(rtol=2e-4, atol=2e-4, lse_rtol=2e-5)
DE_TOL = dict(rtol=2e-4, atol=2e-4)
ZSTEP_TOL = dict(rtol=1e-5, atol=1e-6)

# (n, k, gp, [(gf, kf, stride, base?, mask?, zmap?)...], zmask, nz): the
# shapes of the reference's ZSTATS_CASES and ALPHA_CASES, plus K = 2
ZSTATS_CASES = {
    "k3": (64, 3, 5, [(3, 17, 1, False, False, False)], False, None),
    "k4": (300, 4, 20, [(4, 33, 1, False, False, False)], False, None),
    "k130": (129, 130, 7, [(130, 5, 1, False, False, False)], False, None),
    "masked": (200, 4, 12, [(4, 21, 1, False, True, False)], True, None),
    "strided-base": (150, 3, 9, [(30, 11, 3, True, False, False)], False, None),
    "strided-masked": (150, 3, 9, [(30, 11, 3, True, True, False)], True, None),
    "stride1-base": (100, 5, 8, [(5, 12, 1, True, False, False)], False, None),
    "multi-child": (120, 3, 6, [(3, 19, 1, False, False, False),
                                (21, 9, 7, True, True, False)], True, None),
    "k2": (500, 2, 1, [(2, 2, 1, False, False, False)], False, None),
    "k1024": (300, 1024, 9, [(1024, 50, 1, False, True, False)], True, None),
    "child-v33000": (4000, 4, 11, [(4, 33000, 1, False, False, False)], False,
                     None),
    "prior-g70000": (4000, 16, 70000, [(16, 33, 1, False, False, False)], True,
                     None),
    # K % 4 == 0 at the main path's lanes per token (4) and at 2: masks, a
    # strided child beside a specialized one, keys of several pieces
    "k100-masked": (300, 100, 20, [(100, 40, 1, False, True, False)], True,
                    None),
    "k100-multi": (250, 100, 9, [(100, 33, 1, False, False, False),
                                 (300, 11, 2, True, True, False)], True, None),
    "k64": (200, 64, 7, [(64, 21, 1, False, False, False)], False, None),
    "k96-long-pieces": (3000, 96, 3, [(96, 5, 1, False, False, False)], False,
                        None),
}
# strided children of a DCM-LDA layout (seed, documents, K, V, mean length,
# hot word share, long run, masked): phi's rows are docs x topics (base doc *
# K, stride 1), so each takes the "runs" pass; a word in 30% of all tokens;
# document 0 holding 1,500 tokens of one word (one run); masks and zmask
RUNS_CASES = {
    "dcm-hot-word": (500, 400, 16, 2000, 120, 0.3, 0, False),
    "dcm-run-1500": (501, 50, 16, 500, 60, 0.0, 1500, False),
    "dcm-masked": (502, 300, 16, 1000, 90, 0.1, 300, True),
}
# the pass each edge case's strided child must take (``ops.route_label``)
STRIDED_ROUTES = {"strided-base": "flat passes=strided",
                  "stride1-base": "flat passes=runs",
                  "multi-child": "flat passes=pieces,runs",
                  "k100-multi": "flat passes=pieces,strided"}
# segment latents: the reference's ZMAP_KERNEL_CASES (masked specialized,
# strided with base, zmap child beside a flat child), two zmap children,
# naive Bayes' long instances (about 500 tokens each, over PIECE) and K = 1024
ZMAP_CASES = {
    "zmap-masked": (240, 3, 10, [(3, 15, 1, False, True, True)], True, 40),
    "zmap-strided": (200, 3, 9, [(30, 11, 3, True, True, True)], False, 35),
    "zmap+flat": (300, 3, 8, [(3, 12, 1, False, False, True),
                              (21, 9, 7, True, True, False)], True, 50),
    "two-zmap": (400, 4, 6, [(4, 20, 1, False, True, True),
                             (4, 9, 1, False, False, True)], False, 60),
    "long-instances": (2000, 5, 1, [(5, 300, 1, False, True, True)], False, 4),
    "zmap-k1024": (3000, 1024, 9, [(1024, 50, 1, False, True, True)], True,
                   300),
    "zmap-k100": (3000, 100, 9, [(100, 50, 1, False, True, True),
                                 (300, 11, 2, True, True, False)], True, 300),
}
# the passes of the segment-latent cases with a strided child: a zmap
# child's is per column; a flat one takes "runs" where its rows are one to
# one over (base, k) (zmap+flat: bases 0..6 at stride 7, K = 3) and
# "strided" where they collide (zmap-k100: stride 2 under K = 100)
ZMAP_ROUTES = {"zmap-strided": "zmap passes=strided logits=group",
               "zmap+flat": "zmap passes=pieces,runs logits=group",
               "zmap-k100": "zmap passes=pieces,strided logits=group"}
# DCM-SLDA layouts (seed, documents, K, V, mean length, hot word share,
# long run, masked): sentences of SENT_LEN tokens over phi's docs x topics
# rows (base doc * K, stride 1), so phi's zmap child takes the "runs" pass; a
# word in 30% of all tokens; document 0 opening with 1,500 tokens of one word
# (one run across 215 sentences); masks of 0, 1 and fractions with a zmask,
# an empty sentence and an all-masked one; K = 100
ZMAP_RUNS_CASES = {
    "dcms-hot-word": (600, 300, 16, 2000, 120, 0.3, 0, False),
    "dcms-run-1500": (601, 50, 16, 500, 60, 0.0, 1500, False),
    "dcms-masked": (602, 200, 16, 1000, 90, 0.1, 300, True),
    "dcms-k100": (603, 60, 100, 500, 90, 0.1, 200, True),
}
# the reference's ALPHA_CASES "zmap" (seed 24, concentration tables)
ZMAP_ALPHA_CASE = (24, 240, 3, 10, [(3, 15, 1, False, True, True)], True, 40)
# the LM trainer: olmo-1b (arXiv:2402.00838), the default --arch of the
# trainer and the server, at full width and depth; batch 4 x 2,048 tokens
LM_ARCH, LM_SEQ, LM_BATCH, LM_STEPS = "olmo-1b", 2048, 4, 4
LM_BH = LM_BATCH * 16           # batch x heads: the flash kernel's batch dim
DEV = "cuda"                    # the LM phases' device
# the reference's flash kernel tolerance (tests/test_kernels.py): f32 sums
# in another order
FLASH_F32_TOL = dict(rtol=2e-4, atol=2e-5)
# two bf16 ulps: the output is rounded to bf16 on both sides, and the kernel
# rounds the softmax weights P to bf16 for the tensor cores' P v
FLASH_BF16_TOL = dict(rtol=2**-7, atol=2**-7)
# flash against dense attention on one batch, in nats: the dense path rounds
# its scores and weights to bf16, the kernel keeps scores in f32; over 8,192
# tokens the per-token differences average out to well under 1e-2
LM_LOSS_TOL = 1e-2
# a batch's loss against the chance level of its own logits, in nats: ten
# times the spread of a mean over 8,192 tokens of per-token CEs of spread ~1
CHANCE_TOL = 0.1
# the reference's FLASH_SHAPES (bh, s, dh)
FLASH_SHAPES = [(1, 32, 16), (2, 64, 16), (1, 100, 32), (3, 96, 8), (2, 48, 64)]
# (bh, sq, sk, dh, causal) at the wgmma route's head dims: one row, a
# ragged query tile, Sq < Sk and Sq > Sk across kv tiles, a non-causal
# ragged Sk, several full tiles
FLASH_WGMMA_CASES = [(1, 1, 1, 64, True), (2, 257, 257, 128, True),
                     (2, 48, 300, 128, True), (2, 300, 200, 64, True),
                     (3, 70, 333, 128, False), (2, 512, 512, 64, True)]
# (bh, s) of the causal bf16 shapes timed at Dh 256: gemma3-4b's global
# layer at batch 1 x 4,096 (the training cycle's and the server's prefill
# shape) and under lm_train's batch 4 x 2,048; both are also checked
FLASH_DH256_TIMED = [(8, 4096), (32, 2048)]
# serving: olmo-1b at batch 8 and gemma3-4b (arXiv:2503.19786) at batch 4,
# full width and depth, prompts of 4,096 tokens from TokenStream, 64 new
# tokens, 8 decode steps profiled; checks in f32 at batch 2, 8 decode steps
# after a chunked prefill of 1,024 tokens (chunk 256; gemma3's window-1,024
# rings wrap at position 1,024) and of 32 tokens (chunk 8; local windows cut
# to 16, so that the rings wrap and one key is 1/33 of those a query reads)
SERVE_CASES = (("olmo-1b", 8), ("gemma3-4b", 4))
SERVE_PROMPT, SERVE_NEW, SERVE_PROFILE_STEPS = 4096, 64, 8
SERVE_CHECK_CASES = ((1024, 256, None), (32, 8, 16))  # prompt, chunk, window
SERVE_CHECK_STEPS = 8
# the reference's test_decode_matches_full_forward tolerance
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
# gemma3-4b's training step: one block cycle, batch 1 x 4,096, 3 steps
GEMMA_SEQ, GEMMA_STEPS = 4096, 3
# checkpoint and resume: olmo-1b at 2 layers, 4 steps, saved at step 2.  The
# embedding gather's backward accumulates rows with atomics on CUDA, so a
# rerun may differ in the last bits of that gradient; AdamW then moves an
# element by lr times its normalised gradient, and the loss over 8,192
# tokens by far less than 1e-3 nats
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY, RESUME_TOL = 2, 4, 2, 1e-3
# DCM-LDA (the paper's Figure 22) at benchmarks/bench_vmp.py's settings (K =
# 16, V = 2,000, the repo's priors, mean length 120), depth raised from 400
# to 10,000 documents (about 1.2M tokens; phi on docs x topics rows is then
# (160,000, 2,000) f32, 1.28 GB); zstats takes phi's stats on the "runs"
# pass
DCM_DOCS, DCM_TOPICS, DCM_VOCAB, DCM_MEAN_LEN, DCM_STEPS = 10000, 16, 2000, \
    120, 10
# experts: qwen3-moe-30b-a3b (hf:Qwen/Qwen3-30B-A3B) at full width, serving
# at depth 8 of 48 (48 f32 layers, about 120 GB, do not fit the card's 80;
# 16 ran until the lm_shard phase needed the time),
# 8 prompts of 4,096 tokens, 64 new tokens; the f32 serving checks at 2
# layers for it and moonshot-v1-16b-a3b (hf:moonshotai/Moonlight-16B-A3B);
# training at 2 layers, batch 4 x 2,048, 4 steps a variant
MOE_ARCH, MOE_SERVE_LAYERS, MOE_SERVE_BATCH = "qwen3-moe-30b-a3b", 8, 8
MOE_CHECK_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
MOE_LAYERS, MOE_SEQ, MOE_BATCH, MOE_STEPS = 2, 2048, 4, 4
MOE_TRAIN_RUNS = (("plain", {}), ("plain again", {}),
                  ("remat full", dict(remat="full")),
                  ("remat dots", dict(remat="dots")),
                  ("microbatch 2", dict(microbatch=2)))
# microbatch 2's first loss against the plain run's, in nats: the mean of two
# half-batch means against one mean over 8,192 tokens, each half routed under
# its own capacity
MOE_MB_TOL = 1e-4
# the checkpoint resume: one layer, its experts cut from 128 to 16 (top-8
# kept) and the vocabulary to 16,384, so that its four passes through the
# store (about 0.2 GB/s on the card's machine) move about 8 GB rather than
# the 88 GB of the full width's optimizer state
MOE_CKPT_LAYERS, MOE_CKPT_EXPERTS, MOE_CKPT_VOCAB = 1, 16, 16384
# the routing's softmax weights against a host recomputation in f64
ROUTE_W_TOL = 1e-6
# recurrent layers: recurrentgemma-2b (arXiv:2402.19427; 26 layers, the
# RG-LRU at width 2,560 and local MQA attention, window 2,048) and
# mamba2-370m (arXiv:2405.21060; 48 SSD layers, state 128) at full width
# and depth through serve, 8 prompts of 4,096 tokens, 64 new tokens; f32
# checks at full width and reduced depth (recurrentgemma one cycle and its
# 2-layer tail, mamba2 2 layers): a prefill of 1,024 tokens (a multiple of
# SSD's 128-token chunk), 128 teacher-forced decode steps against one
# training forward over the 1,152 tokens, at the initialisation's weights
# and at a long-memory edit (lam -4: the RG-LRU's a in 0.87-1; dt_bias -5:
# SSD's decay about 0.993 a step), where zeroing one layer's h, or its
# conv state, must leave the tolerance
RECUR_SERVE = (("recurrentgemma-2b", 8), ("mamba2-370m", 8))
RECUR_CHECK_LAYERS = {"recurrentgemma-2b": 5, "mamba2-370m": 2}
RECUR_PROMPT, RECUR_DECODE, RECUR_CHUNK = 1024, 128, 256
RECUR_LONG_MEMORY = {"lam": -4.0, "dt_bias": -5.0}
# training at 4 x 2,048: mamba2 at 24 of 48 layers (48 ran until the
# lm_shard phase needed the time), plain and remat="full";
# recurrentgemma at 8 of 26 layers (two cycles and the 2-layer tail): all 26
# hold 2.894B f32 parameters, 46.3 GB with the AdamW moments before any
# activation; beside the 256,000-column head's f32 logits and about 3-4 GB
# of activations a layer, 11 layers ran out of the card's 79.18 GiB, and 8
# peaked at 78.48 GB (73.1 GiB) on an NVIDIA H100 80GB HBM3 at 700 W
RECUR_TRAIN = (("mamba2-370m", 24, ("plain", "remat full")),
               ("recurrentgemma-2b", 8, ("plain",)))
# RECUR_STEPS steps a run; the first (allocation, autotuning) is dropped
# from the step times, and the mean and median of the other seven are kept
RECUR_SEQ, RECUR_BATCH, RECUR_STEPS = 2048, 4, 8
# the encoder and the frontends: whisper-large-v3 (arXiv:2212.04356; 32
# encoder and 32 decoder layers, d 1,280, 20 heads of 64, layernorm, gelu,
# vocab 51,866) and internvl2-1b (arXiv:2404.16821; 24 layers, d 896, 14
# query heads over 2 kv heads of 64, vocab 151,655, a prefix of 256 patch
# embeddings) at full width and depth, bf16 compute.  Serving: 8 streams;
# whisper's 1,500 frames (30 s of audio after its stride-2 convolution,
# stubbed as embeddings from a numpy seed) and its start-of-transcript
# prompt (<|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>,
# whisper-large-v3's token ids), internvl2's 256 patches and 3,840 tokens;
# 64 greedy tokens, 8 decode steps profiled
ENC_WHISPER, ENC_VLM = "whisper-large-v3", "internvl2-1b"
ENC_FRAMES, ENC_SOT = 1500, (50258, 50259, 50360, 50364)
ENC_SERVE_BATCH, ENC_VLM_TEXT, ENC_NEW, ENC_PROFILE_STEPS = 8, 3840, 64, 8
# f32 checks at full width, batch 2, (encoder, decoder) layers: whisper's
# 4-token prompt, internvl2's 256 patches and 768 tokens (1,024 positions,
# chunk 256: the chunked prefill); 32 teacher-forced decode steps
ENC_CHECK_LAYERS = {ENC_WHISPER: (2, 2), ENC_VLM: (0, 2)}
ENC_CHECK_VLM_PROMPT, ENC_CHECK_CHUNK, ENC_CHECK_STEPS = 768, 256, 32
# training at full depth through build_train_step: internvl2 4 x (256
# patches + 1,792 tokens); whisper 1,500 frames and 448 tokens (its
# decoder's limit) a stream, at the largest batch that fits the card: the
# encoder's dense attention saves f32 scores and softmax and bf16 weights
# of 20 x 1,500^2 a layer and stream; batch 4 ran out of the card's 79.18
# GiB, 3 peaked at 72.17 GB (NVIDIA H100 80GB HBM3, 700 W)
ENC_TRAIN = ((ENC_VLM, 4, 1792), (ENC_WHISPER, 3, 448))
ENC_TRAIN_STEPS = 8
SHAPES = [(1, 2), (3, 5), (7, 128), (33, 96), (128, 130), (257, 4),
          (64, 300), (1000, 3), (5, 102660), (70000, 16)]


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def log(*a):
    print(*a, flush=True)


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# inputs and comparisons
# ---------------------------------------------------------------------------

def zcase(seed, n, k, gp, cfgs, zmask=False, nz=None, positive=False,
          dtype=torch.float32, device="cuda"):
    """The reference's ``_zcase`` draws (and ``_gamma_case`` concentrations
    when ``positive``), as port inputs on ``device``."""
    return to_port(zcase_np(seed, n, k, gp, cfgs, zmask, nz, positive),
                   dtype, device)


def zcase_np(seed, n, k, gp, cfgs, zmask=False, nz=None, positive=False):
    """The draws of :func:`zcase` as numpy: ``(prior table, prior rows,
    [(table, values, stride, zmap, base, mask)...], zmask)``."""
    rng = np.random.default_rng(seed)
    nz = nz or n
    et = rng.normal(size=(gp, k)).astype(np.float32)
    rows = rng.integers(0, gp, nz).astype(np.int32)
    raw = []
    for (gf, kf, stride, has_base, has_mask, has_zmap) in cfgs:
        nt = n if has_zmap else nz
        vals = rng.integers(0, kf, nt).astype(np.int32)
        base = rng.integers(0, max(gf - stride * (k - 1), 1), nt).astype(
            np.int32) if has_base else None
        mask = (rng.random(nt) > 0.25).astype(np.float32) if has_mask else None
        zmap = np.sort(rng.integers(0, nz, nt)).astype(np.int32) \
            if has_zmap else None
        tab = rng.normal(size=(gf, kf)).astype(np.float32)
        raw.append((tab, vals, stride, zmap, base, mask))
    zm = (rng.random(nz) > 0.15).astype(np.float32) if zmask else None
    if positive:
        prng = np.random.default_rng(101)

        def pos(t):
            return (prng.gamma(1.0, 1.0, t.shape) + 1e-2).astype(np.float32)
        et = pos(et)
        raw = [(pos(r[0]),) + r[1:] for r in raw]
    return et, rows, raw, zm


def runs_case_np(seed, docs, k, vocab, mean_len, hot, run, masked):
    """A :data:`RUNS_CASES` draw as :func:`zcase_np`'s numpy case: theta's
    row is the document, phi's rows docs x topics; a share ``hot`` of the
    tokens is word 0, and document 0 opens with ``run`` tokens of word 1."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(mean_len // 2, mean_len * 3 // 2 + 1, docs)
    lens[0] += run
    doc = np.repeat(np.arange(docs), lens).astype(np.int32)
    words = rng.choice(vocab, len(doc), p=rng.dirichlet(
        np.full(vocab, BETA))).astype(np.int32)
    words[rng.random(len(doc)) < hot] = 0
    words[:run] = 1
    mask = (rng.random(len(doc)) > 0.25).astype(np.float32) if masked \
        else None
    zm = (rng.random(len(doc)) > 0.15).astype(np.float32) if masked else None
    tab = rng.normal(size=(docs * k, vocab)).astype(np.float32)
    return (rng.normal(size=(docs, k)).astype(np.float32), doc,
            [(tab, words, 1, None, (doc * k).astype(np.int32), mask)], zm)


def zmap_runs_case_np(seed, docs, k, vocab, mean_len, hot, run, masked):
    """A :data:`ZMAP_RUNS_CASES` draw as :func:`zcase_np`'s numpy case, a
    DCM-SLDA layout: each document cut into sentences (:func:`sentences`),
    the latent's instances, whose prior row is their document; phi's rows
    docs x topics (base doc * K, stride 1), the zmap each token's sentence.
    A share ``hot`` of the tokens is word 0, and document 0 opens with
    ``run`` tokens of word 1.  ``masked``: token masks of 0, 1 and
    fractions, a zmask, sentence 0 without tokens and every token of
    sentence 2 masked."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(mean_len // 2, mean_len * 3 // 2 + 1, docs)
    lens[0] += run
    doc = np.repeat(np.arange(docs), lens).astype(np.int32)
    words = rng.choice(vocab, len(doc), p=rng.dirichlet(
        np.full(vocab, BETA))).astype(np.int32)
    words[rng.random(len(doc)) < hot] = 0
    words[:run] = 1
    tok_sent, sent_doc = sentences({"lengths": lens, "doc_ids": doc})
    mask = zm = None
    if masked:
        tok_sent = tok_sent + 1                  # sentence 0: no tokens
        sent_doc = np.r_[sent_doc[:1], sent_doc].astype(np.int32)
        u = rng.random(len(doc))
        mask = np.where(u < 0.2, 0.0, np.where(
            u < 0.6, rng.uniform(0.05, 1.0, len(doc)), 1.0))
        mask = np.where(tok_sent == 2, 0.0, mask).astype(np.float32)
        zm = (rng.random(len(sent_doc)) > 0.15).astype(np.float32)
    tab = rng.normal(size=(docs * k, vocab)).astype(np.float32)
    return (rng.normal(size=(docs, k)).astype(np.float32), sent_doc,
            [(tab, words, 1, tok_sent.astype(np.int32),
              (doc * k).astype(np.int32), mask)], zm)


def to_port(case, dtype=torch.float32, device="cuda"):
    """A numpy case as the port's ``(table_prior, prior_rows, children,
    zmask)`` on ``device``, tables in ``dtype``."""
    from repro_torch.kernels.ref import ZChild
    et, rows, raw, zm = case

    def dev(a, dt=None):
        if a is None:
            return None
        t = torch.from_numpy(a).to(device)
        return t.to(dt) if dt is not None else t

    children = tuple(ZChild(dev(t, dtype), dev(v), s, dev(z), dev(b), dev(m))
                     for t, v, s, z, b, m in raw)
    return dev(et, dtype), dev(rows), children, dev(zm)


def errors(got, want):
    got, want = got.double(), want.double()
    abs_err = (got - want).abs()
    rel = abs_err / want.abs().clamp_min(1e-30)
    return float(abs_err.max()) if abs_err.numel() else 0.0, \
        float(rel.max()) if rel.numel() else 0.0


def within(got, want, rtol, atol):
    return bool(torch.all((got.double() - want.double()).abs()
                          <= atol + rtol * want.double().abs()))


def compare_zstats(label, got, want, tol=ZSTATS_TOL, name="zstats"):
    """Max abs / rel error of the kernel's outputs against the plain
    version's; fails outside the tolerance."""
    ok = within(got[0], want[0], tol["lse_rtol"], tol["atol"])
    worst = [errors(got[0], want[0])]
    for g, w in [(got[1], want[1])] + list(zip(got[2], want[2])):
        ok &= g.shape == w.shape and within(g, w, tol["rtol"], tol["atol"])
        worst.append(errors(g, w))
    ab, rel = max(e[0] for e in worst), max(e[1] for e in worst)
    log(f"  {name} {label:<28} max_abs {ab:.3e} max_rel {rel:.3e} "
        f"(rtol {tol['rtol']}, atol {tol['atol']}, lse rtol {tol['lse_rtol']}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {label} disagrees with its plain version")
    return ab


def compare(name, label, got, want, tol):
    ab, rel = errors(got, want)
    ok = got.shape == want.shape and within(got, want, tol["rtol"], tol["atol"])
    log(f"  {name} {label:<24} max_abs {ab:.3e} max_rel {rel:.3e} "
        f"(rtol {tol['rtol']}, atol {tol['atol']}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {label} disagrees with its plain version")
    return ab


def output_digest(posteriors, trace):
    """sha256 of the posteriors' f32 bytes (in name order) and the ELBO
    trace's f64 bytes: two runs with one digest gave the same output bit for
    bit."""
    h = hashlib.sha256()
    for n in sorted(posteriors):
        h.update(np.ascontiguousarray(posteriors[n], np.float32).tobytes())
    h.update(np.asarray(trace, np.float64).tobytes())
    return h.hexdigest()


def bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def flat_out(out):
    """A ``zstats`` result ``(lse, prior stats, child stats)`` as one tuple
    of tensors."""
    return (out[0], out[1], *out[2])


def digest_note(label, digest):
    """``digest`` beside the path's known one (:data:`KNOWN_DIGESTS`)."""
    known = KNOWN_DIGESTS.get(label)
    if known is None:
        return digest
    return (f"{digest} ({'the same as' if digest == known else 'DIFFERENT FROM'}"
            f" the known full-depth {known[:8]}…)")


def time_ms(fn, reps, warmup=1):
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(report):
    """Build both CUDA libraries at once (one ``nvcc`` per source, started
    together), print what ``-Xptxas -v`` says of each kernel, and load
    them."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import flash_attention, fused_zstats
    mods = (fused_zstats, flash_attention)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = [ex.submit(m.build, verbose=True) for m in mods]
        built = [f.result() for f in futs]
    secs = time.perf_counter() - t0
    for m, (lib, out) in zip(mods, built):
        log(f"[build] nvcc {m._SRC.relative_to(ROOT)} -> {lib.name}")
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or " 0 bytes spill stores" not in line \
                    and "spill" in line:
                log(f"  {entry[:48]:<48} {line.split(':', 1)[-1].strip()}")
        m.library()
    for dh in flash_attention.WGMMA_DH:
        log(f"  flash_wgmma_kernel<{dh}> dynamic shared memory "
            f"{flash_attention.library().flash_attention_wgmma_smem(dh)} bytes")
    log(f"[build] both libraries in {secs:.2f} s")
    report["build_s"] = secs


def de_plain(a, transpose=False):
    """``dirichlet_expectation``'s plain version, in the kernel's layout."""
    from repro_torch.kernels import ref
    out = ref.dirichlet_expectation(a.float())
    return out.T if transpose else out


def phase_kernels_vs_plain(report):
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import fused_zstats as fz
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vmp_zstep as zs
    log("[kernels vs plain] edge cases")
    cases = [(label, i, lambda t, i=i, c=case: zcase(
        100 + i, *c, positive=t == "alpha")) for i, (label, case) in
        enumerate(ZSTATS_CASES.items())]
    cases += [(label, None, lambda t, c=case: to_port(runs_case_np(*c)))
              for label, case in RUNS_CASES.items()]
    twice = {}
    for label, i, make in cases:
        for tables in ("elog", "alpha") if i is not None else ("elog",):
            args = make(tables)
            got = fz.zstats(*args, tables=tables)
            compare_zstats(f"{label}/{tables}", got,
                           ref.zstats(*args, tables=tables))
            route = ops.routing(*args[:3], tables=tables).label
            want = STRIDED_ROUTES.get(label, "flat passes=runs" if i is None
                                      else None)
            check(want is None or route == want,
                  f"zstats {label}: route {route!r}, not {want!r}")
            check(bitwise(flat_out(got), flat_out(fz.zstats(
                *args, tables=tables))), f"zstats {label}/{tables}: two "
                  f"launches differ")
            for kind in route.split("passes=")[1].split(","):
                twice.setdefault(kind, []).append(label)
    check(set(twice) == {"pieces", "runs", "strided"},
          f"zstats edge cases took the passes {sorted(twice)}")
    log("  zstats: two launches bitwise on every case, by pass: " + "; ".join(
        f"{k} {len(v)} ({', '.join(sorted(set(v)))})"
        for k, v in sorted(twice.items())))
    for label in ("k4", "strided-masked", "child-v33000"):
        for tables in ("elog", "alpha"):
            args = zcase(200, *ZSTATS_CASES[label], positive=tables == "alpha",
                         dtype=torch.bfloat16)
            compare_zstats(f"{label}/{tables}/bf16",
                           fz.zstats(*args, tables=tables),
                           ref.zstats(*args, tables=tables))
    for shape in SHAPES:
        rng = np.random.default_rng(shape[0] * 7 + shape[1])
        a = torch.from_numpy((rng.gamma(1.0, 1.0, size=shape) + 1e-2)
                             .astype(np.float32)).cuda()
        compare("dirichlet_expectation", f"{shape}", de.dirichlet_expectation(a),
                de_plain(a), DE_TOL)
        compare("dirichlet_expectation", f"{shape}/T",
                de.dirichlet_expectation(a, transpose=True),
                de_plain(a, transpose=True), DE_TOL)
        ab = a.to(torch.bfloat16)
        compare("dirichlet_expectation", f"{shape}/bf16",
                de.dirichlet_expectation(ab), de_plain(ab), DE_TOL)
        if shape[1] <= 8192:
            x = torch.from_numpy((rng.normal(size=shape) * 4)
                                 .astype(np.float32)).cuda()
            r, lse = zs.zstep(x)
            rp, lp = ref.zstep(x)
            compare("zstep", f"{shape} r", r, rp, ZSTEP_TOL)
            compare("zstep", f"{shape} lse", lse, lp,
                    dict(rtol=1e-5, atol=1e-5))
    torch.cuda.synchronize()


def zmap_variants():
    """(label, numpy case, tables) of every segment-latent case: the cases
    above in elog and alpha mode, the reference's alpha "zmap" case, an
    unsorted zmap, an instance with no tokens beside one whose tokens are
    all masked."""
    out = []
    for i, (label, case) in enumerate(ZMAP_CASES.items()):
        for tables in ("elog", "alpha"):
            out.append((f"{label}/{tables}",
                        zcase_np(400 + i, *case, positive=tables == "alpha"),
                        tables))
    out.append(("alpha-zmap/alpha", zcase_np(*ZMAP_ALPHA_CASE, positive=True),
                "alpha"))
    et, rows, raw, zm = zcase_np(410, *ZMAP_CASES["zmap+flat"])
    perm = np.random.default_rng(411).permutation(len(raw[0][1]))
    tab, vals, stride, zmap, base, mask = raw[0]
    raw[0] = (tab, vals[perm], stride, zmap[perm], base, mask)
    out.append(("unsorted-zmap/elog", (et, rows, raw, zm), "elog"))
    et, rows, raw, zm = zcase_np(412, *ZMAP_CASES["zmap-masked"])
    tab, vals, stride, zmap, base, mask = raw[0]
    zmap = np.where(zmap == 0, 1, zmap).astype(np.int32)     # instance 0: empty
    mask = np.where(zmap == 2, 0.0, mask).astype(np.float32)  # 2: all masked
    raw[0] = (tab, vals, stride, zmap, base, mask)
    out.append(("empty+masked-instance/elog", (et, rows, raw, zm), "elog"))
    return out


def phase_zmap_kernels():
    """``zstats_zmap`` and ``zmap_logits`` against ``ref.zstats`` and
    ``ref.zmap_logits`` on every segment-latent case, f32 and bf16 tables;
    a plan from ``ops.zstats_plan`` and a repeated call change no bit."""
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ops, ref
    log("[kernels vs plain] segment latents (zstats_zmap, zmap_logits)")
    worst = {"zstats_zmap": 0.0, "zmap_logits": 0.0}
    bf16 = ("zmap-masked", "zmap-strided", "zmap+flat")
    for label, case, tables in zmap_variants():
        dtypes = [torch.float32]
        if label.split("/")[0] in bf16:
            dtypes.append(torch.bfloat16)
        for dt in dtypes:
            tag = label + ("/bf16" if dt == torch.bfloat16 else "")
            args = to_port(case, dt)
            want = ZMAP_ROUTES.get(label.split("/")[0])
            route = ops.routing(*args[:3], tables=tables).label
            check(want is None or route == want,
                  f"zstats_zmap {tag}: route {route!r}, not {want!r}")
            worst["zstats_zmap"] = max(worst["zstats_zmap"], compare_zstats(
                tag, fzm.zstats_zmap(*args, tables=tables),
                ref.zstats(*args, tables=tables), name="zstats_zmap"))
            zkids = tuple(c for c in args[2] if c.zmap is not None)
            nz, k = args[1].shape[0], args[0].shape[1]
            worst["zmap_logits"] = max(worst["zmap_logits"], compare(
                "zmap_logits", tag,
                fzm.zmap_logits(zkids, nz, k, tables=tables),
                ref.zmap_logits(zkids, nz, k, tables=tables),
                dict(rtol=ZSTATS_TOL["rtol"], atol=ZSTATS_TOL["atol"])))
    log("  strided children on their passes: " + ", ".join(
        f"{k} {v.split()[1]}" for k, v in ZMAP_ROUTES.items()))
    log("[kernels vs plain] DCM-SLDA layouts: phase 2b on the runs pass")
    for label, case in ZMAP_RUNS_CASES.items():
        err = zmap_runs_check(label, to_port(zmap_runs_case_np(*case)))[0]
        worst["zstats_zmap"] = max(worst["zstats_zmap"], err)
    args = to_port(zcase_np(420, *ZMAP_CASES["zmap+flat"]))
    plan = ops.zstats_plan(*args[:3])
    a = fzm.zstats_zmap(*args, plan=plan)
    b = fzm.zstats_zmap(*args)
    check(bitwise((a[0], a[1], *a[2]), (b[0], b[1], *b[2])),
          "zstats_zmap with and without a plan differ")
    log("  zstats_zmap with ops.zstats_plan's plan and without: bitwise equal")
    torch.cuda.synchronize()
    return worst


def zmap_runs_check(label, args, plan=None):
    """``zstats_zmap`` on ``args`` (a segment latent whose strided zmap child
    takes phase 2b's runs pass; ``plan`` its owner plan, built here when
    None) against ``ref.zstats``, two launches bitwise, and bitwise the
    per-column pass at the same inputs (a plan built ``per_column``), each
    plan on the route it names.  Returns (max abs error, the plan, the
    per-column plan)."""
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ops, ref
    if plan is None:
        plan = ops.zstats_plan(*args[:3])
    col = fzm.build_zmap_plan(args[1], args[2], tuple(args[0].shape),
                              per_column=True).to(args[0].device)
    routes = [ops.routing(*args[:3], plan=p).label for p in (plan, col)]
    want = [EXPECTED_ROUTE["dcmslda"], "zmap passes=strided logits=group"]
    check(routes == want, f"zstats_zmap {label}: routes {routes}, not {want}")
    got = fzm.zstats_zmap(*args, plan=plan)
    err = compare_zstats(label, got, ref.zstats(*args), name="zstats_zmap")
    again = fzm.zstats_zmap(*args, plan=plan)
    per_col = fzm.zstats_zmap(*args, plan=col)
    check(bitwise(flat_out(got), flat_out(again)),
          f"zstats_zmap {label}: two launches of the runs pass differ")
    check(bitwise(flat_out(got), flat_out(per_col)),
          f"zstats_zmap {label}: the runs pass differs from the per-column "
          f"pass at the same inputs")
    log(f"  zstats_zmap {label}: two launches bitwise; bitwise the "
        f"per-column pass ({routes[1]})")
    return err, plan, col


def make_main_model(args):
    from repro_torch.core import models
    from repro_torch.data import SyntheticCorpus
    t0 = time.perf_counter()
    corpus = SyntheticCorpus(n_docs=args.docs, vocab=VOCAB, n_topics=TOPICS,
                             alpha=ALPHA, beta=BETA, mean_len=MEAN_LEN,
                             seed=SEED).generate()
    m = models.make("lda", alpha=ALPHA, beta=BETA, K=TOPICS, V=VOCAB)
    m["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    prog = m.compile()
    log(f"[main] corpus D={args.docs} V={VOCAB} K={TOPICS} "
        f"N={len(corpus['tokens'])} tokens, made and compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    return corpus, m, prog


def phase_main(args, report, corpus, m, prog):
    from repro_torch.kernels import ops
    n = len(corpus["tokens"])
    steps = args.steps
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.infer(steps=steps, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    after_infer = ops.launch_counts()
    routes = ops.route_counts()
    r = m["z"].get_result()
    counts = ops.launch_counts()
    trace = m.elbo_trace
    log(f"[main] infer(steps={steps}) {infer_s:.2f} s (first step builds the "
        f"owner plan); ELBO {trace[0]:.6e} -> {trace[-1]:.6e}")
    log(f"[main] launches: {counts}")
    check(after_infer["zstats"] == steps,
          f"zstats launched {after_infer['zstats']} times in {steps} steps")
    check(counts["dirichlet_expectation"] > 0 and counts["zstep"] == 1,
          f"get_result('z') did not run the Triton kernels: {counts}")
    scale = abs(trace[-1])
    diffs = np.diff(trace)
    check(bool((diffs >= -1e-6 * scale).all()),
          f"ELBO not monotone within 1e-6 relative: {diffs.tolist()}")
    posts = {n: m[n].get_result() for n in ("theta", "phi")}
    digest = output_digest(posts, trace)
    log(f"[main] sha256 of the final posteriors and ELBO trace: "
        f"{digest_note('main', digest)}")
    theta, phi = (posts[n].astype(np.float64) for n in ("theta", "phi"))
    sums = {"theta": theta.sum() - theta.size * ALPHA,
            "phi": phi.sum() - phi.size * BETA}
    for name, s in sums.items():
        log(f"[main] sum of {name} stats {s:.1f} vs N = {n} "
            f"(rel {abs(s - n) / n:.2e}, tol 1e-5)")
        check(abs(s - n) <= 1e-5 * n, f"{name} stats do not sum to N")
    row_err = float(np.abs(r.sum(axis=1, dtype=np.float64) - 1.0).max())
    log(f"[main] q(z) {r.shape}: max |row sum - 1| = {row_err:.2e} (tol 1e-5)")
    check(r.shape == (n, TOPICS) and np.isfinite(r).all()
          and row_err <= 1e-5, "q(z) rows do not sum to 1")
    from repro_torch.core.metrics import aligned_tv
    tv = aligned_tv(phi / phi.sum(-1, keepdims=True), corpus["true_phi"])
    log(f"[main] aligned_tv(phi, planted) = {tv:.4f} after {steps} steps")
    explain_check("main", m, routes, EXPECTED_ROUTE["main"])
    report.update(routes=routes, infer_launches=after_infer,
                  elbo_trace=trace, launches=counts, aligned_tv=tv,
                  infer_s=infer_s, stats_sums=sums, n_tokens=n, digest=digest)
    return counts


def phase_repeat_and_time(args, report, m, prog, counts):
    from repro_torch.core import runtime, vmp
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import fused_zstats as fz
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vmp_zstep as zs
    steps = args.steps
    state = m._state
    spec = prog.latents[0]
    arrays = vmp._program_arrays(prog, state.device)
    f = spec.children[0]
    theta, phi = state.posteriors["theta"], state.posteriors["phi"]
    # zstats' inputs as the VMP step hands them over: Elog tables, phi's
    # made as (V, K) and passed as its (K, V) transpose
    e_theta = de.dirichlet_expectation(theta)
    e_phi = de.dirichlet_expectation(phi, transpose=True).T
    child = ops.ZChild(elog=e_phi, values=arrays[f.x_name]["values"])
    rows = arrays[spec.name]["prior_rows"]
    plan = ops.zstats_plan(e_theta, rows, (child,))
    n = rows.shape[0]

    log("[repeat] bitwise repeatability")
    a = fz.zstats(e_theta, rows, (child,), plan=plan)
    b = fz.zstats(e_theta, rows, (child,), plan=plan)
    check(bitwise((a[0], a[1], *a[2]), (b[0], b[1], *b[2])),
          "two zstats calls on the same inputs differ")
    posts, step = vmp.state_to_numpy(state)
    runs = [runtime.run_inference(prog, steps=3, device="cuda",
                                  state=vmp.state_from_numpy(posts, step, "cuda"))
            for _ in range(2)]
    check(runs[0][1] == runs[1][1] and all(
        torch.equal(runs[0][0].posteriors[k], runs[1][0].posteriors[k])
        for k in posts), "two 3-step runs from one state differ")
    log("  two zstats calls and two 3-step runs from one state: bitwise equal")

    log("[kernels vs plain] main path shapes")
    want = ref.zstats(e_theta, rows, (child,))
    zs_err = compare_zstats("main path", a, want)
    de_err = max(compare("dirichlet_expectation", "theta (D, K)",
                         e_theta, de_plain(theta), DE_TOL),
                 compare("dirichlet_expectation", "phi (K, V) as (V, K)",
                         e_phi.T, de_plain(phi, transpose=True), DE_TOL))
    elog = {"theta": e_theta, "phi": e_phi}
    logits = vmp._messages_to_latent(prog, spec, elog, arrays, None)
    del elog
    r, lse = zs.zstep(logits)
    rp, lp = ref.zstep(logits)
    zstep_err = max(compare("zstep", "main path r", r, rp, ZSTEP_TOL),
                    compare("zstep", "main path lse", lse, lp,
                            dict(rtol=1e-5, atol=1e-5)))
    del r, lse, rp, lp
    torch.cuda.synchronize()

    log("[times] CUDA events at the main path's shapes")
    g, k = theta.shape
    v = phi.shape[1]
    t_z = time_ms(lambda: fz.zstats(e_theta, rows, (child,), plan=plan),
                  reps=10)
    t_zp = time_ms(lambda: ref.zstats(e_theta, rows, (child,)), reps=3)
    t_de = time_ms(lambda: de.dirichlet_expectation(phi, transpose=True), reps=20)
    t_de_dev = device_ms(lambda: de.dirichlet_expectation(phi, transpose=True))
    t_dep = time_ms(lambda: de_plain(phi, transpose=True).contiguous(), reps=5)
    t_de_theta = time_ms(lambda: de.dirichlet_expectation(theta), reps=20)
    t_s = time_ms(lambda: zs.zstep(logits), reps=5)
    t_sp = time_ms(lambda: ref.zstep(logits), reps=3)
    t_softmax = time_ms(lambda: torch.softmax(logits, dim=-1), reps=5)
    s_bound = work_bound("zstep", logits)
    del logits
    # VMP step: host clock around steps that end in a synchronize
    t_step, step, st = time_steps(prog, state)

    trace = phase_trace(step, st)
    per_step = {name: counts[name] / steps for name in counts}
    kernels = []
    for name, route, src, rep, ms, pms, (bms, by), err in [
        ("zstats", "cuda", "src/repro_torch/kernels/csrc/zstats.cu",
         "src/repro/kernels/fused_zstats.py:685", t_z, t_zp,
         work_bound("zstats", e_theta, rows, (child,)), zs_err),
        ("dirichlet_expectation", "triton",
         "src/repro_torch/kernels/dirichlet_expectation.py",
         "src/repro/kernels/dirichlet_expectation.py:52", t_de, t_dep,
         work_bound("dirichlet_expectation", phi), de_err),
        ("zstep", "triton", "src/repro_torch/kernels/vmp_zstep.py",
         "src/repro/kernels/vmp_zstep.py:40", t_s, t_sp, s_bound,
         zstep_err),
    ]:
        kernels.append(kernel_entry("lda", name, route, src, rep, counts[name],
                                    err, ms, pms, bms, by))
        log(f"  {name:<22} {ms:9.4f} ms  plain {pms:9.4f} ms  bound "
            f"{bms:8.4f} ms ({by})  launches {counts[name]} "
            f"({per_step[name]:.1f} per step)")
    # the Elog pass is small enough that CUDA events around its calls time
    # the host's launches: its entry also carries its device time
    next(e for e in kernels if e["name"] == "dirichlet_expectation")[
        "device_ms"] = t_de_dev
    log(f"  dirichlet_expectation on phi as (V, K): device time {t_de_dev:.4f} "
        f"ms a call (CUDA graph of 20 calls)")
    log(f"  dirichlet_expectation at theta's (D, K) = ({g}, {k}): "
        f"{t_de_theta:.4f} ms, bound "
        f"{work_bound('dirichlet_expectation', theta)[0]:.4f} ms")
    de_split = {"phi": de_passes("phi", phi), "theta": de_passes(
        "theta", theta, transpose=False)}
    log(f"  torch.softmax beside zstep (not used by the port): "
        f"{t_softmax:.4f} ms")
    log(f"  VMP step: {t_step:.2f} ms, {n / t_step * 1e3:.4e} tokens/s "
        f"(N = {n})")
    kernels += path_dirichlet_entries("lda", prog, st, counts)
    report.update(kernels=kernels, step_ms=t_step,
                  tokens_per_s=n / t_step * 1e3, softmax_ms=t_softmax,
                  de_theta_ms=t_de_theta, de_passes=de_split,
                  launches_per_step=per_step,
                  trace=trace)
    return kernels


def device_ms(fn, reps=20):
    """Device time per call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the graph's replays timed with CUDA events.  CUDA events around
    back-to-back calls of a small kernel measure the host's launch cost
    instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, reps=3) / reps
    del graph
    return ms


def de_passes(label, alpha, transpose=True):
    """Log the Elog pass's two Triton launches on ``alpha`` timed apart
    (the row sums into chunk partials, the elementwise pass), each by CUDA
    events and by device time; returns them."""
    from repro_torch.kernels import dirichlet_expectation as de
    part = de.row_sums(alpha)
    runs = {"rowsum": lambda: de.row_sums(alpha),
            "elementwise": lambda: de.elog_from_sums(alpha, part, transpose)}
    out = {"chunks": part.shape[1]}
    for name, fn in runs.items():
        out[f"{name}_ms"] = time_ms(fn, reps=20)
        out[f"{name}_device_ms"] = device_ms(fn)
    log(f"  dirichlet_expectation {label} {tuple(alpha.shape)} by launch "
        f"(events / device): row sums ({part.shape[1]} chunks a row) "
        f"{out['rowsum_ms']:.4f} / {out['rowsum_device_ms']:.4f} ms, "
        f"elementwise{' (transposed)' if transpose else ''} "
        f"{out['elementwise_ms']:.4f} / {out['elementwise_device_ms']:.4f} ms")
    return out


def work_bound(name, *args):
    """(least ms on the card, "bytes" or "operations") of one call of kernel
    ``name`` on ``args``: its work (``kernels/work.py``) over the card's
    peaks (``launch/roofline.py:bound``), flash's products at the bf16
    tensor-core rate, the other kernels' operations at f32's."""
    from repro_torch.kernels import work
    from repro_torch.launch.roofline import PEAK_FLOPS, bound
    ops, nbytes = getattr(work, name)(*args)
    return bound(nbytes, ops, PEAK_FLOPS if name == "flash_attention"
                 else None)


def kernel_entry(path, name, route, src, replaces, launches, err, ms, plain_ms,
                 bound_ms, bound_by, library_ms=None):
    """One entry of the kernels line; ``path`` names the path (lda, slda,
    naive_bayes) whose run gave ``launches`` and whose shapes were timed."""
    return {"path": path, "name": name, "route": route, "source": src,
            "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def parse_route(label):
    """(path, passes, logits) of a route label (``ops.route_label``:
    ``"zmap passes=pieces logits=group"``)."""
    path, *rest = label.split()
    kv = dict(t.split("=", 1) for t in rest)
    return (path, tuple(kv["passes"].split(",")) if "passes" in kv else (),
            tuple(kv["logits"].split(",")) if "logits" in kv else ())


def explained_routes(text):
    """``{latent: route label}`` of the kernel-route lines of an EXPLAIN."""
    import re
    return dict(re.findall(r"^    latent (\S+) \(prior \S+\): "
                           r"route=(.+) tokens=\d+ K=\d+$", text, re.M))


def route_check(label, what, route, counts):
    """``route`` (path, passes, logits) is the route that the launches of
    ``counts`` (``ops.route_counts()``) took: its wrapper launched every
    pass kind and logits route it names and no other, the other wrapper
    nothing, and ``zmap_logits`` no other logits route."""
    from repro_torch.kernels.ops import route_label
    path, passes, logits = route
    wrapper, other = (("zstats", "zstats_zmap") if path == "flat"
                      else ("zstats_zmap", "zstats"))
    seen = {k for k, v in counts[wrapper].items() if v}
    lseen = {k for k, v in counts["zmap_logits"].items() if v}
    ok = (path in ("flat", "zmap") and seen == set(passes) | set(logits)
          and not any(counts[other].values()) and lseen <= set(logits))
    log(f"[{label}] {what}: route {route_label(*route)}; {wrapper} "
        f"launches by route {counts[wrapper]}, zmap_logits "
        f"{counts['zmap_logits']}: {'the same route' if ok else 'DIFFERENT'}")
    check(ok, f"{label}: {what} names {route_label(*route)}, the launches "
          f"took {counts}")


def explain_check(label, m, counts, expect, config=None):
    """``explain_plan(m, config, backend="cuda")`` names the route
    ``expect`` for the model's one latent, and it is the route that the
    run's launches took (``counts``: ``ops.route_counts()`` read just after
    it).  Returns the plan."""
    from repro_torch.analysis.explain import explain_plan
    t0 = time.perf_counter()
    plan = explain_plan(m, config, backend="cuda")
    plan_s = time.perf_counter() - t0
    (r,) = plan.routes
    check(r.label == expect, f"{label}: explain_plan names {r.label!r}, "
          f"not {expect!r}")
    route_check(label, f"explain_plan(backend='cuda') in {plan_s:.2f} s "
                f"(owner plan {r.plan_bytes} bytes)",
                (r.path, r.passes, r.logits), counts)
    return plan


def time_steps(prog, state, reps=5):
    """ms per VMP step (host clock around ``reps`` steps, each ending in the
    ELBO's ``float``, after one warm-up step) and the state after them."""
    from repro_torch.core import runtime, vmp
    posts, _ = vmp.state_to_numpy(state)
    step = runtime.make_step(prog, device="cuda")
    st, _ = step(vmp.state_from_numpy(posts, step=0, device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        st, elbo = step(st)
        float(elbo)
    return (time.perf_counter() - t0) / reps * 1e3, step, st


# ---------------------------------------------------------------------------
# segment latents: SLDA and naive Bayes through make_engine("vmp")
# ---------------------------------------------------------------------------

def sentences(corpus):
    """Each document cut into sentences of SENT_LEN tokens, the last one
    shorter; no sentence straddles two documents.  Returns (sentence of each
    token, document of each sentence)."""
    lengths, doc_ids = corpus["lengths"], corpus["doc_ids"]
    per_doc = (lengths + SENT_LEN - 1) // SENT_LEN
    first_tok = np.cumsum(lengths) - lengths
    first_sent = np.cumsum(per_doc) - per_doc
    pos = np.arange(len(doc_ids)) - first_tok[doc_ids]
    tok_sent = (first_sent[doc_ids] + pos // SENT_LEN).astype(np.int32)
    sent_doc = np.repeat(np.arange(len(lengths), dtype=np.int32), per_doc)
    return tok_sent, sent_doc


def make_slda(corpus):
    """SLDA at the main path's widths over the main path's corpus."""
    from repro_torch.core import models
    t0 = time.perf_counter()
    tok_sent, sent_doc = sentences(corpus)
    m = models.make("slda", alpha=ALPHA, beta=BETA, K=TOPICS, V=VOCAB)
    m["x"].observe(corpus["tokens"], segment_ids=tok_sent)
    m.bind("sents", sent_doc)
    m.compile()
    log(f"[slda] {len(sent_doc)} sentences of <= {SENT_LEN} tokens over "
        f"{len(corpus['lengths'])} documents, N = {len(tok_sent)}; observed "
        f"and compiled in {time.perf_counter() - t0:.1f} s")
    return m


def make_naive_bayes(args):
    """Naive Bayes at the 20 Newsgroups "bydate" widths over a planted
    corpus of the main path's mean length (depth scaled with --docs)."""
    from repro_torch.core import models
    from repro_torch.data import SyntheticCorpus
    t0 = time.perf_counter()
    docs = max(NB_DOCS * args.docs // 30000, 100)
    corpus = SyntheticCorpus(n_docs=docs, vocab=NB_VOCAB, n_topics=NB_CLASSES,
                             alpha=ALPHA, beta=BETA, mean_len=MEAN_LEN,
                             seed=SEED).generate()
    m = models.make("naive_bayes", alpha=ALPHA, beta=BETA, C=NB_CLASSES,
                    V=NB_VOCAB)
    m["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    m.compile()
    log(f"[naive_bayes] C={NB_CLASSES} V={NB_VOCAB} D={docs} "
        f"N={len(corpus['tokens'])} tokens, made and compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    return m


def phase_segment(label, m, steps, latent, report):
    """One segment-latent path through ``make_engine("vmp").fit`` and
    ``get_result``, launch counts set to 0 just before and read just after,
    with the checks of the main path and two bitwise repeats."""
    from repro_torch.core import make_engine, runtime, vmp
    from repro_torch.kernels import ops
    prog = m.compile()
    spec = prog.latents[0]
    n_inst, n_tok = spec.n, len(spec.children[0].values)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = make_engine("vmp", steps=steps, seed=SEED, device="cuda").fit(m)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = ops.launch_counts()
    fit_routes = ops.route_counts()
    r = m[latent].get_result()
    r_again = m[latent].get_result()
    counts = ops.launch_counts()
    trace = res.elbo_trace
    log(f"[{label}] make_engine('vmp', steps={steps}).fit {fit_s:.2f} s "
        f"(first step builds the owner plan); ELBO {trace[0]:.6e} -> "
        f"{trace[-1]:.6e}")
    log(f"[{label}] launches: {counts}")
    check(fit_counts["zstats_zmap"] == steps and fit_counts["zstats"] == 0,
          f"{label}: zstats_zmap launched {fit_counts['zstats_zmap']} times "
          f"in {steps} steps (flat zstats {fit_counts['zstats']})")
    check(counts["zmap_logits"] == 2 and counts["zstep"] == 2,
          f"{label}: get_result did not run zmap_logits and zstep: {counts}")
    diffs = np.diff(trace)
    check(bool((diffs >= -1e-6 * abs(trace[-1])).all()),
          f"{label}: ELBO not monotone within 1e-6 relative: {diffs.tolist()}")
    want = {spec.prior_dir: n_inst, spec.children[0].dir_name: n_tok}
    sums = {}
    for name, n in want.items():
        prior = prog.dirichlets[name].prior.astype(np.float64)
        sums[name] = float((res.posteriors[name].astype(np.float64)
                            - prior[None, :]).sum())
        log(f"[{label}] sum of {name} stats {sums[name]:.1f} vs {n} "
            f"(rel {abs(sums[name] - n) / n:.2e}, tol 1e-5)")
        check(abs(sums[name] - n) <= 1e-5 * n,
              f"{label}: {name} stats do not sum to {n}")
    row_err = float(np.abs(r.sum(axis=1, dtype=np.float64) - 1.0).max())
    log(f"[{label}] q({latent}) {r.shape}: max |row sum - 1| = {row_err:.2e} "
        f"(tol 1e-5)")
    check(r.shape == (n_inst, spec.k) and np.isfinite(r).all()
          and row_err <= 1e-5, f"{label}: q({latent}) rows do not sum to 1")
    check(np.array_equal(r, r_again),
          f"{label}: two get_result('{latent}') calls differ")
    posts, step = vmp.state_to_numpy(m._state)
    runs = [runtime.run_inference(prog, steps=3, device="cuda",
                                  state=vmp.state_from_numpy(posts, step, "cuda"))
            for _ in range(2)]
    check(runs[0][1] == runs[1][1] and all(
        torch.equal(runs[0][0].posteriors[k], runs[1][0].posteriors[k])
        for k in posts), f"{label}: two 3-step runs from one state differ")
    log(f"[{label}] two get_result('{latent}') calls and two 3-step runs "
        f"from one state: bitwise equal")
    _, t16 = runtime.run_inference(prog, steps=3, device="cuda",
                                   state=vmp.state_from_numpy(posts, step, "cuda"),
                                   elog_dtype="bfloat16")
    rel = max(abs(a - b) / abs(b) for a, b in zip(t16, runs[0][1]))
    log(f"[{label}] 3 steps on bf16 concentration tables: ELBO within "
        f"{rel:.2e} of f32 (tol 2e-2, the tables' bf16 rounding)")
    check(rel <= 2e-2, f"{label}: bf16 tables move the ELBO by {rel:.2e}")
    digest = output_digest(res.posteriors, trace)
    log(f"[{label}] sha256 of the final posteriors and ELBO trace: "
        f"{digest_note(label, digest)}")
    explain_check(label, m, fit_routes, EXPECTED_ROUTE[label])
    report[label] = dict(elbo_trace=trace, launches=counts, fit_s=fit_s,
                         routes=fit_routes,
                         stats_sums=sums, n_tokens=n_tok, n_latent=n_inst,
                         digest=digest)
    return counts


def phase_segment_times(label, m, report, counts):
    """Every kernel of a segment-latent path against its plain version on
    the path's own inputs (``zstats_zmap``, ``zmap_logits``, the Elog pass
    on each Dirichlet's table, ``zstep`` on the latent's logits), their
    times and bounds, and the path's entries of the kernels line, with the
    path's ``counts``; then the path's step in ms and tokens/s and its
    trace."""
    from repro_torch.core import vmp
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ref
    from repro_torch.kernels import vmp_zstep as zs
    from repro_torch.kernels import work
    from repro_torch.launch.roofline import HBM_BW
    prog, state = m.compile(), m._state
    spec = prog.latents[0]
    n_inst, n_tok, k = spec.n, len(spec.children[0].values), spec.k
    log(f"[kernels vs plain] {label} shapes")
    arrays = vmp._program_arrays(prog, state.device)
    tabs = vmp._elog_tables(prog, state)
    children = vmp._latent_children(spec, tabs, arrays)
    rows = arrays[spec.name]["prior_rows"]
    plan = vmp.program_plans(prog, arrays)[spec.name]
    prior = tabs[spec.prior_dir]
    err = compare_zstats(f"{label} path", fzm.zstats_zmap(
        prior, rows, children, plan=plan), ref.zstats(prior, rows, children),
        name="zstats_zmap")
    lerr = compare("zmap_logits", f"{label} path",
                   fzm.zmap_logits(children, n_inst, k, plan=plan),
                   ref.zmap_logits(children, n_inst, k),
                   dict(rtol=ZSTATS_TOL["rtol"], atol=ZSTATS_TOL["atol"]))
    # the Elog pass as the step makes it: a specialized child's table as
    # (V, K), the others as they are
    child_dir = spec.children[0].dir_name
    de_err = 0.0
    for name, p in state.posteriors.items():
        tr = name == child_dir
        de_err = max(de_err, compare(
            "dirichlet_expectation", f"{label} {name} {tuple(p.shape)}"
            + (" as (V, K)" if tr else ""),
            de.dirichlet_expectation(p, transpose=tr),
            de_plain(p, transpose=tr), DE_TOL))
    logits = vmp._messages_to_latent(prog, spec, tabs, arrays, plan)
    r, lse = zs.zstep(logits)
    rp, lp = ref.zstep(logits)
    zstep_err = max(compare("zstep", f"{label} r {tuple(logits.shape)}", r,
                            rp, ZSTEP_TOL),
                    compare("zstep", f"{label} lse", lse, lp,
                            dict(rtol=1e-5, atol=1e-5)))
    del r, lse, rp, lp
    torch.cuda.synchronize()

    phi = state.posteriors[child_dir]
    t_z = time_ms(lambda: fzm.zstats_zmap(prior, rows, children, plan=plan),
                  reps=10)
    t_zp = time_ms(lambda: ref.zstats(prior, rows, children), reps=3)
    t_l = time_ms(lambda: fzm.zmap_logits(children, n_inst, k, plan=plan),
                  reps=10)
    t_lp = time_ms(lambda: ref.zmap_logits(children, n_inst, k), reps=3)
    t_de = time_ms(lambda: de.dirichlet_expectation(phi, transpose=True),
                   reps=20)
    t_de_dev = device_ms(lambda: de.dirichlet_expectation(phi, transpose=True))
    t_dep = time_ms(lambda: de_plain(phi, transpose=True).contiguous(), reps=5)
    t_s = time_ms(lambda: zs.zstep(logits), reps=5)
    t_sp = time_ms(lambda: ref.zstep(logits), reps=3)
    s_bound = work_bound("zstep", logits)
    del logits
    z_bytes = work.zstats_zmap(prior, rows, children)[1]
    # logits and r (f32), and the f64 partials of the instances of several
    # pieces (phase 1 writes a one-piece instance's row itself), each
    # written and read once; the K-rows phases 1 and 2b gather, one each a
    # token (the message, r[zmap]), beside them
    n_parts = sum(int(plan.streams[f"latent{j}", "fstart"][-1])
                  for j in range(len(plan.by_latent)))
    inter = 2 * (2 * n_inst * k * 4 + n_parts * k * 8)
    gathered = 2 * n_tok * k * 4
    entries = []
    for name, route, src, rep, ms, pms, (bms, by), e in [
        ("zstats_zmap", "cuda", "src/repro_torch/kernels/csrc/zstats.cu",
         "src/repro/kernels/fused_zmap.py:236", t_z, t_zp,
         work_bound("zstats_zmap", prior, rows, children), err),
        ("zmap_logits", "cuda", "src/repro_torch/kernels/csrc/zstats.cu",
         "src/repro/kernels/fused_zmap.py:165", t_l, t_lp,
         work_bound("zmap_logits", children, n_inst, k), lerr),
        ("dirichlet_expectation", "triton",
         "src/repro_torch/kernels/dirichlet_expectation.py",
         "src/repro/kernels/dirichlet_expectation.py:52", t_de, t_dep,
         work_bound("dirichlet_expectation", phi), de_err),
        ("zstep", "triton", "src/repro_torch/kernels/vmp_zstep.py",
         "src/repro/kernels/vmp_zstep.py:40", t_s, t_sp, s_bound,
         zstep_err),
    ]:
        entries.append(kernel_entry(label, name, route, src, rep,
                                    counts[name], e, ms, pms, bms, by))
        log(f"  {name:<22} {ms:9.4f} ms  plain {pms:9.4f} ms  bound "
            f"{bms:8.4f} ms ({by})  launches {counts[name]}")
    next(e for e in entries if e["name"] == "dirichlet_expectation")[
        "device_ms"] = t_de_dev
    log(f"  dirichlet_expectation on {child_dir} as (V, K): device time "
        f"{t_de_dev:.4f} ms a call (CUDA graph of 20 calls)")
    log(f"  zstats_zmap with its intermediates (f32 logits and r, "
        f"{n_parts} f64 partial rows of the logits, each written and read "
        f"once): {(z_bytes + inter) / HBM_BW * 1e3:.4f} ms of "
        f"traffic; the K-rows that phases 1 and 2b gather (2 N K 4 bytes, "
        f"{gathered / 1e9:.2f} GB): "
        f"{gathered / HBM_BW * 1e3:.4f} ms at the memory rate")
    de_split = de_passes(f"{label} {child_dir}", phi)
    entries += path_dirichlet_entries(label, prog, state, counts)
    t_step, step, st = time_steps(prog, state)
    log(f"  {label} VMP step: {t_step:.2f} ms, {n_tok / t_step * 1e3:.4e} "
        f"tokens/s (N = {n_tok}, {n_inst} latent instances)")
    report[label].update(zstats_zmap_ms=t_z, zmap_logits_ms=t_l,
                         intermediate_bytes=inter, gathered_bytes=gathered,
                         partial_rows=n_parts, de_passes=de_split,
                         step_ms=t_step,
                         tokens_per_s=n_tok / t_step * 1e3,
                         trace=phase_trace(step, st))
    return entries


def phase_trace(step, st, n_steps=2):
    """Device time by kernel over ``n_steps`` VMP steps (torch.profiler),
    and the device's idle share of the steps' wall time."""
    def run():
        nonlocal st
        for _ in range(n_steps):
            st, elbo = step(st)
            float(elbo)
    return profile_steps(run, n_steps)


def profile_steps(run, n_steps, label="trace"):
    """Run ``run()`` (``n_steps`` steps, each ending in a host read of its
    result) under torch.profiler: device time by kernel per step and the
    device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        # kernels only: the aten ops that launch them carry the same time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / n_steps / 1e3, ev.count // n_steps, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    step_ms = wall_us / n_steps / 1e3
    idle = f"{1 - busy_ms / step_ms:.3f}" if rows else "not measured"
    log(f"[{label}] {n_steps} steps under torch.profiler: {step_ms:.3f} ms per "
        f"step, device busy {busy_ms:.3f} ms, idle share {idle}")
    for ms, cnt, key in rows[:12]:
        log(f"  {ms:9.4f} ms/step  x{cnt:<3} {key[:90]}")
    return {"step_ms": step_ms, "busy_ms": busy_ms,
            "kernels": [{"ms_per_step": ms, "calls_per_step": c, "name": k}
                        for ms, c, k in rows]}


# ---------------------------------------------------------------------------
# SVI: minibatches of the main path's program, and of SLDA's and naive Bayes'
# ---------------------------------------------------------------------------

# Hoffman et al. (JMLR 2013)'s defaults, as the reference's SVIConfig carries
# them, at a batch of 1,024 documents (about 340k of the main path's tokens);
# 30 steps are about one epoch of the 28,500 training documents
SVI_BATCH, SVI_STEPS, SVI_REPEAT_STEPS, SVI_SEGMENT_STEPS = 1024, 30, 5, 5
SVI_TIMED_STEPS = 5
# padding leaves the update unchanged up to the order of f32 sums (the
# reference's own bound, tests/test_svi.py)
SVI_PAD_TOL = dict(rtol=2e-5, atol=2e-5, elbo_rtol=1e-5)


def svi_config(**kw):
    from repro_torch.core.svi import SVIConfig
    return SVIConfig(**{**dict(batch_size=SVI_BATCH, kappa=0.7, tau=10.0,
                               pad_multiple=256, holdout_frac=0.05,
                               holdout_every=10, holdout_local_iters=10,
                               seed=SEED), **kw})


def svi_equals_vmp(label, prog):
    """One SVI step at |B| = G, exact caps, rho = 1 and the documents in
    order, from the path's initial state, against one full-batch VMP step
    (``runtime.make_step``): every posterior and the ELBO, bitwise."""
    from repro_torch.core import runtime, vmp
    from repro_torch.core.svi import SVI
    g = prog.meta["pstar_size"]
    s0 = vmp.init_state(prog, SEED, device="cuda")
    want, e_want = runtime.make_step(prog, device="cuda")(s0)
    svi = SVI(prog, svi_config(batch_size=g, rho=1.0, pad_multiple=0,
                               shuffle=False, holdout_frac=0.0),
              device="cuda")
    got, e_got = svi.step(0, s0)
    ok = float(e_got) == float(e_want) and all(
        torch.equal(got.posteriors[n], want.posteriors[n])
        for n in want.posteriors)
    log(f"[{label}] one SVI step at |B| = G = {g}, rho = 1, exact caps, "
        f"against one VMP step: {'bitwise equal' if ok else 'DIFFERENT'} "
        f"(ELBO {float(e_got):.9e} / {float(e_want):.9e})")
    check(ok, f"{label}: SVI at |B| = G, rho = 1 is not bitwise VMP")


def svi_fit_checks(label, cfg, hist, counts, latent_kernel, steps):
    """Every batch ELBO finite, every held-out ELBO finite, and the latent's
    kernel launched ``local_iters`` times a step and ``holdout_local_iters
    + 1`` times an evaluation."""
    evals = len(hist["heldout"])
    want = steps * cfg.local_iters + evals * (cfg.holdout_local_iters + 1)
    log(f"[{label}] batch ELBO {hist['elbo'][0]:.6e} -> "
        f"{hist['elbo'][-1]:.6e}; held-out per token "
        f"{[round(v, 6) for _, v in hist['heldout']]} at steps "
        f"{[t for t, _ in hist['heldout']]}")
    log(f"[{label}] launches: {counts}")
    check(len(hist["elbo"]) == steps and np.isfinite(hist["elbo"]).all(),
          f"{label}: a batch ELBO is not finite")
    check(evals > 0 and np.isfinite([v for _, v in hist["heldout"]]).all(),
          f"{label}: a held-out ELBO is not finite")
    check(counts[latent_kernel] == want,
          f"{label}: {latent_kernel} launched {counts[latent_kernel]} times, "
          f"not {want} ({steps} steps, {evals} held-out evaluations)")
    check(counts["dirichlet_expectation"] > 0,
          f"{label}: the Elog pass did not launch")


def svi_batch_inputs(fit, state, t):
    """The inputs the step hands its latent's kernel on batch ``t``: the
    batch's slice, owner plan and masks on the card, the step's own sliced
    state (``svi.sliced_state``: the batch's local rows, padding rows at the
    prior) and its Elog tables.  Returns (n_tokens, sliced state, (args of
    zstats), plan, the shadow's latent)."""
    from repro_torch.core import compiler, vmp
    from repro_torch.core import svi as svi_mod
    prog = fit.program
    hb, caps, n_tok = fit._load_groups(fit.sampler.batch_at(t))[:3]
    batch = svi_mod.device_put_batch(hb, "cuda")
    shadow = compiler.sliced_shadow(prog, caps)
    st = svi_mod.sliced_state(prog, state, batch)
    tabs = vmp._elog_tables(shadow, st)
    spec = shadow.latents[0]
    a = batch["arrays"]
    args = (tabs[spec.prior_dir], a[spec.name]["prior_rows"],
            vmp._latent_children(spec, tabs, a), a[spec.name]["mask"])
    return n_tok, st, args, batch["plans"][spec.name], spec


def svi_pad_check(label, prog, fit, s0):
    """Batch 0 of ``fit`` at exact caps against the same batch padded to
    the fit's caps (the masked kernel route against the unmasked one), one
    step at rho 0.5 and scale 2 from ``s0``: every posterior within
    SVI_PAD_TOL and the ELBO within its rtol.  Returns (the batch's groups,
    the padded step's state, the largest posterior difference)."""
    from repro_torch.core import svi as svi_mod
    groups = fit.sampler.batch_at(0)
    stepped = {}
    for kind, caps_fn in (("exact", None), ("padded", fit._caps_fn)):
        batch, caps, n_tok = svi_mod.device_batch(prog, groups, caps_fn,
                                                  "cuda")
        stepped[kind] = svi_mod.make_svi_step(prog, caps)(s0, batch, 0.5, 2.0)
    (se, ee), (sp, ep) = stepped["exact"], stepped["padded"]
    tol = SVI_PAD_TOL
    ok = abs(float(ep) - float(ee)) <= tol["elbo_rtol"] * abs(float(ee))
    worst = 0.0
    for n in se.posteriors:
        ok &= within(sp.posteriors[n], se.posteriors[n], tol["rtol"],
                     tol["atol"])
        worst = max(worst, errors(sp.posteriors[n], se.posteriors[n])[0])
    log(f"[{label}] batch 0 ({len(groups)} documents, {n_tok} tokens) padded "
        f"to caps {caps} against exact caps, rho 0.5, scale 2: posteriors "
        f"max_abs {worst:.3e}, ELBO {float(ep):.9e} / {float(ee):.9e} (rtol "
        f"{tol['rtol']}, atol {tol['atol']}, ELBO rtol {tol['elbo_rtol']}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: padding changes the update")
    return groups, sp, worst


def phase_lda_svi(report, prog, m):
    """SVI over the main path's program: bitwise VMP at |B| = G, padding
    invariance, untouched rows, two bitwise 5-step runs, the 30-step fit
    with its launch counts, the route and caps of ``explain_plan`` against
    the fit's (``m`` is the main path's model), ``zstats`` (masked route) and the Elog pass
    against their plain versions at one batch's inputs, and the step's time
    split between the host (slicing, owner plan, copy) and the card.
    Returns the kernels entries, the fit's final state, its held-out
    documents and its last held-out ELBO."""
    from repro_torch.core import vmp
    from repro_torch.core import svi as svi_mod
    from repro_torch.kernels import ops
    label = "lda_svi"
    out = report[label] = {}
    svi_equals_vmp(label, prog)
    g = prog.meta["pstar_size"]
    s0 = vmp.init_state(prog, SEED, device="cuda")
    cfg = svi_config()
    fit = svi_mod.SVI(prog, cfg, device="cuda")

    groups, sp, worst = svi_pad_check(label, prog, fit, s0)
    rest = torch.from_numpy(np.setdiff1d(np.arange(g), groups)).cuda()
    mine = torch.from_numpy(groups).cuda()
    theta0, theta1 = s0.posteriors["theta"], sp.posteriors["theta"]
    ok = torch.equal(theta1[rest], theta0[rest]) \
        and not torch.equal(theta1[mine], theta0[mine])
    log(f"[{label}] the {len(rest)} documents outside the batch keep their "
        f"theta rows bitwise, the batch's move: {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: a step wrote theta rows outside its batch")
    del sp

    digests = []
    for _ in range(2):
        st, hist = svi_mod.SVI(prog, cfg, device="cuda").fit(
            SVI_REPEAT_STEPS, state=s0)
        digests.append(output_digest(vmp.state_to_numpy(st)[0],
                                     hist["elbo"] + [v for _, v in
                                                     hist["heldout"]]))
    log(f"[{label}] two {SVI_REPEAT_STEPS}-step runs from one state: sha256 "
        f"{digests[0]} / {digests[1]}")
    check(digests[0] == digests[1], f"{label}: two runs from one state differ")

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = fit.fit(SVI_STEPS, state=s0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = ops.route_counts()
    svi_fit_checks(label, cfg, hist, counts, "zstats", SVI_STEPS)
    plan = explain_check(label, m, routes, EXPECTED_ROUTE["main"], cfg)
    caps0 = fit._load_groups(fit.sampler.batch_at(0))[1]
    log(f"[{label}] explain_plan's caps {plan.caps}, batch 0's "
        f"{caps0}: {'equal' if plan.caps == caps0 else 'DIFFERENT'}")
    check(plan.caps == caps0, f"{label}: the plan's caps are not batch 0's")
    held = [v for _, v in hist["heldout"]]
    log(f"[{label}] fit({SVI_STEPS}) {fit_s:.2f} s; held-out per-token ELBO "
        f"{held[0]:.6f} -> {held[-1]:.6f}")
    check(held[-1] > held[0], f"{label}: the held-out ELBO did not rise")
    digest = output_digest(vmp.state_to_numpy(state)[0], hist["elbo"] + held)
    log(f"[{label}] sha256 of the final posteriors, batch and held-out ELBO "
        f"traces: {digest_note(label, digest)}")

    entries = svi_flat_kernels(label, fit, state, counts)
    entries += path_dirichlet_entries(label, prog, state, counts)
    out.update(svi_step_times(label, fit, state, report["device"]))
    out.update(elbo_trace=hist["elbo"], heldout=hist["heldout"],
               launches=counts, fit_s=fit_s, digest=digest,
               repeat_digests=digests, pad_max_abs=worst)
    return entries, state, fit.holdout, held[-1]


def svi_flat_kernels(label, fit, state, counts):
    """``zstats`` (the masked flat route) and the Elog pass at the inputs
    of ``fit``'s batch SVI_STEPS from ``state``, held against their plain
    versions and timed beside their bound; the kernels-line entries of
    path ``label`` with the launch ``counts`` of its fit."""
    log(f"[kernels vs plain] {label}: one batch's inputs (padded, masked)")
    _, st_b, args, plan, _ = svi_batch_inputs(fit, state, SVI_STEPS)
    entries = flat_kernel_entries(label, args, plan,
                                  st_b.posteriors["theta"], counts,
                                  "the batch's theta rows")
    del args, plan, st_b
    return entries


def flat_kernel_entries(label, args, plan, theta, counts, rows, extra=()):
    """``zstats`` (``args`` and its ``plan``) and the Elog pass on
    ``theta`` (the ``rows`` of one batch or request), each held against its
    plain version and timed beside its bound, then each of ``extra``
    (``(name, route, source, replaces, ms, plain_ms, (bound_ms, by),
    err)``): the kernels-line entries of path ``label`` with its launch
    ``counts``."""
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import fused_zstats as fz
    from repro_torch.kernels import ops, ref
    zerr = compare_zstats(f"{label} inputs", fz.zstats(*args, plan=plan),
                          ref.zstats(*args))
    variant = ops.routing(*args[:3], plan=plan).label
    de_err = compare("dirichlet_expectation", f"{label} theta rows "
                     f"{tuple(theta.shape)}",
                     de.dirichlet_expectation(theta), de_plain(theta),
                     DE_TOL)
    t_z = time_ms(lambda: fz.zstats(*args, plan=plan), reps=20)
    t_zp = time_ms(lambda: ref.zstats(*args), reps=3)
    t_de = time_ms(lambda: de.dirichlet_expectation(theta), reps=20)
    t_de_dev = device_ms(lambda: de.dirichlet_expectation(theta))
    t_dep = time_ms(lambda: de_plain(theta).contiguous(), reps=5)
    entries = []
    for name, route, src, rep, ms, pms, (bms, by), e in [
        ("zstats", "cuda", "src/repro_torch/kernels/csrc/zstats.cu",
         "src/repro/kernels/fused_zstats.py:685", t_z, t_zp,
         work_bound("zstats", *args), zerr),
        ("dirichlet_expectation", "triton",
         "src/repro_torch/kernels/dirichlet_expectation.py",
         "src/repro/kernels/dirichlet_expectation.py:52", t_de, t_dep,
         work_bound("dirichlet_expectation", theta), de_err),
        *extra,
    ]:
        entries.append(kernel_entry(label, name, route, src, rep,
                                    counts[name], e, ms, pms, bms, by))
        log(f"  {name:<22} {ms:9.4f} ms  plain {pms:9.4f} ms  bound "
            f"{bms:8.4f} ms ({by})  launches {counts[name]}")
    entries[0]["variant"] = variant
    entries[1]["device_ms"] = t_de_dev
    log(f"  zstats took the route {variant}; dirichlet_expectation on {rows}: "
        f"device time {t_de_dev:.4f} ms a call (CUDA graph of 20 calls)")
    return entries


def svi_step_times(label, fit, state, dev_line, warm=0):
    """Per step, over SVI_TIMED_STEPS steps after the fit (and ``warm``
    untimed ones): host-clock ms of ``SVI.step`` (each ending in the ELBO's
    ``float``) and tokens/s, and inside those same steps the host ms of the
    slicing, of the owner plans and of the host-to-device copy (the spans
    ``svi.slice``, ``svi.plan`` and ``svi.h2d`` recorded by
    ``repro_torch.trace``, a mean of each span's instances; out of core the
    first two on the prefetch thread, and the caller's wait for the batch,
    ``svi.wait``); device ms and idle share under
    torch.profiler over the next SVI_TIMED_STEPS steps; the held-out
    evaluation's ms, cold (slice and plan) and cached."""
    from repro_torch import trace as spans
    from repro_torch.core import svi as svi_mod
    prog = fit.program
    st = state
    for t in range(SVI_STEPS, SVI_STEPS + warm):
        st, elbo = fit.step(t, st)
        float(elbo)
    t_first = SVI_STEPS + warm
    steps = range(t_first, t_first + SVI_TIMED_STEPS)
    tokens = float(np.mean([fit._weights[fit.sampler.batch_at(t)].sum()
                            for t in steps]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with spans.recording():
        for t in steps:
            st, elbo = fit.step(t, st)
            float(elbo)
    step_ms = (time.perf_counter() - t0) / len(steps) * 1e3
    parts = {}
    for r in spans.records():
        if r.name.startswith("svi.") and r.end_ns is not None:
            parts.setdefault(r.name[4:], []).append(r.host_ms)
    ms = {k: float(np.mean(v)) for k, v in parts.items()}
    st2 = st

    def run():
        nonlocal st2
        for t in range(t_first + SVI_TIMED_STEPS,
                       t_first + 2 * SVI_TIMED_STEPS):
            st2, elbo = fit.step(t, st2)
            float(elbo)
    trace = profile_steps(run, SVI_TIMED_STEPS, label=f"{label} trace")
    t0 = time.perf_counter()
    svi_mod.heldout_elbo(prog, st, fit.holdout, fit.cfg.holdout_local_iters,
                         cache={}, slicer=fit._slicer)
    cold_ms = (time.perf_counter() - t0) * 1e3
    fit.heldout_elbo(st)
    t0 = time.perf_counter()
    fit.heldout_elbo(st)
    held_ms = (time.perf_counter() - t0) * 1e3
    host = ms["slice"] + ms["plan"] + ms["h2d"]
    idle = (f"{1 - trace['busy_ms'] / trace['step_ms']:.3f}"
            if trace["busy_ms"] > 0 else "not measured")
    if "wait" in ms:
        caller = ms["wait"] + ms["h2d"]
        split = (f"slice_sharded {ms['slice']:.2f} ms and owner plan "
                 f"{ms['plan']:.2f} ms on the prefetch thread; on the "
                 f"caller's thread the wait for the batch {ms['wait']:.2f} "
                 f"ms, H2D {ms['h2d']:.2f} ms ({caller:.2f} ms before the "
                 f"kernels, {step_ms - caller:.2f} ms the rest)")
    else:
        split = (f"slice_arrays {ms['slice']:.2f} ms, owner plan "
                 f"{ms['plan']:.2f} ms, H2D {ms['h2d']:.2f} ms ({host:.2f} "
                 f"ms of host work before the kernels, {step_ms - host:.2f} "
                 f"ms the rest)")
    log(f"[{label} times] {dev_line}: per step over {len(steps)} steps of "
        f"{tokens:.0f} tokens: {step_ms:.2f} ms host clock, "
        f"{tokens / step_ms * 1e3:.4e} tokens/s; inside those steps "
        f"{split}; device "
        f"{trace['busy_ms']:.3f} ms a step, idle share {idle}; held-out "
        f"evaluation ({len(fit.holdout)} documents, "
        f"{fit.cfg.holdout_local_iters + 1} step bodies) {held_ms:.2f} ms "
        f"cached, {cold_ms:.2f} ms cold")
    return dict(step_ms=step_ms, tokens_per_step=tokens,
                tokens_per_s=tokens / step_ms * 1e3, slice_ms=ms["slice"],
                plan_ms=ms["plan"], h2d_ms=ms["h2d"],
                wait_ms=ms.get("wait"), host_parts=parts,
                heldout_ms=held_ms, heldout_cold_ms=cold_ms, trace=trace,
                idle_share=(1 - trace["busy_ms"] / trace["step_ms"]
                            if trace["busy_ms"] > 0 else None))


# ---------------------------------------------------------------------------
# out of core: the main path's corpus on disk, streamed; sessions and
# crash-resume; a growing corpus; VMP checkpoints
# ---------------------------------------------------------------------------

# 20 steps with a session every 5, the crash entering step 12 (the 13th
# trip of "svi.step"); the growing run: the first two thirds of the
# documents (20,000 of 30,000), the rest appended after step 10, a crash
# entering step 27
OOC_STEPS, OOC_EVERY, OOC_CRASH_AT = 20, 5, 13
GROW_APPEND_AFTER, GROW_CRASH_AT = 10, 28
CHILD_TIMEOUT = 600

# the child of the SIGKILL check: the 20 out-of-core steps with sessions,
# armed through REPRO_FAULTS; it loads the kernel library the parent built
OOC_CHILD = """
import sys
sys.path.insert(0, {src!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.core import models
from repro_torch.core.svi import SVI, SVIConfig
from repro_torch.data import ShardedCorpus, sharded_template
corpus = ShardedCorpus.open({path!r})
model = models.make("lda", alpha={alpha!r}, beta={beta!r}, K={k!r}, V={v!r})
fit = SVI(sharded_template(model, corpus), SVIConfig(**{cfg!r}),
          corpus=corpus, device="cuda")
fit.fit({steps!r}, checkpoint_dir={ck!r}, checkpoint_every={every!r},
        callback=lambda t, e: print(f"STEP {{t}}", flush=True))
print("DONE", flush=True)
"""


def ooc_config(**kw):
    """:func:`svi_config` as keyword values (the child rebuilds it)."""
    cfg = svi_config(**kw)
    return {f: getattr(cfg, f) for f in (
        "batch_size", "kappa", "tau", "pad_multiple", "holdout_frac",
        "holdout_every", "holdout_local_iters", "seed", "growing",
        "capacity_docs", "prefetch")}


def states_bitwise(a, b, ha, hb):
    """Posteriors and step of two SVI states, and their histories (batch
    and held-out ELBO), all equal bit for bit."""
    return int(a.step) == int(b.step) and ha == hb and all(
        torch.equal(a.posteriors[n], b.posteriors[n]) for n in a.posteriors)


def ooc_sessions(label, tmp, tmpl, path):
    """Crash-resume out of core: the uninterrupted OOC_STEPS; the same run
    with ``svi.step`` armed to raise entering step OOC_CRASH_AT - 1,
    resumed in this process from its newest session; a child process with
    the same steps armed through REPRO_FAULTS to SIGKILL itself there, the
    parent resuming from its newest valid session.  Both resumes must end
    bitwise at the uninterrupted run."""
    import os
    from repro_torch.checkpoint import latest_session_step
    from repro_torch.core.svi import SVI
    from repro_torch.data import ShardedCorpus
    from repro_torch.testing import faults
    cfg = svi_config()

    def svi():
        return SVI(tmpl, cfg, corpus=ShardedCorpus.open(path), device="cuda")

    t0 = time.perf_counter()
    ref = svi()
    want, want_h = ref.fit(OOC_STEPS)
    ref.close()
    ck = str(tmp / "ck_raise")
    crash = svi()
    with faults.inject("svi.step", nth=OOC_CRASH_AT):
        try:
            crash.fit(OOC_STEPS, checkpoint_dir=ck, checkpoint_every=OOC_EVERY)
            raised = False
        except faults.InjectedCrash:
            raised = True
    crash.close()
    step = latest_session_step(ck)
    again = svi()
    got, got_h = again.fit(OOC_STEPS - (step or 0), checkpoint_dir=ck,
                           resume_from=True)
    again.close()
    ok = raised and step == 10 and states_bitwise(got, want, got_h, want_h)
    log(f"[{label}] crash-resume in one process: svi.step=raise@"
        f"{OOC_CRASH_AT} {'raised' if raised else 'DID NOT RAISE'}, newest "
        f"session at step {step}, resumed {OOC_STEPS - (step or 0)} steps: "
        f"{'bitwise the uninterrupted run' if ok else 'DIFFERENT'} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(ok, f"{label}: in-process crash-resume is not bitwise")

    t0 = time.perf_counter()
    ck = str(tmp / "ck_kill")
    code = OOC_CHILD.format(src=str(ROOT / "src"), path=path, alpha=ALPHA,
                            beta=BETA, k=TOPICS, v=VOCAB, cfg=ooc_config(),
                            steps=OOC_STEPS, ck=ck, every=OOC_EVERY)
    env = dict(os.environ, **{faults.ENV_VAR: f"svi.step=kill@{OOC_CRASH_AT}"})
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT)
    done = [int(line.split()[1]) for line in res.stdout.splitlines()
            if line.startswith("STEP ")]
    step = latest_session_step(ck)
    log(f"[{label}] SIGKILL child: exit {res.returncode} after "
        f"{time.perf_counter() - t0:.1f} s, steps {done[:1]}..{done[-1:]} "
        f"done, newest valid session at step {step}")
    if res.returncode != -9:
        log(res.stderr[-4000:])
    check(res.returncode == -9 and done == list(range(OOC_CRASH_AT - 1))
          and step is not None,
          f"{label}: the child did not die by SIGKILL entering step "
          f"{OOC_CRASH_AT - 1} with a session")
    again = svi()
    got, got_h = again.fit(OOC_STEPS - step, checkpoint_dir=ck,
                           resume_from=True)
    again.close()
    ok = states_bitwise(got, want, got_h, want_h)
    log(f"[{label}] resumed the killed child's run from step {step}: "
        f"{'bitwise the uninterrupted run' if ok else 'DIFFERENT'}")
    check(ok, f"{label}: resume after SIGKILL is not bitwise")
    return {"crash_session_step": 10, "kill_session_step": step}


def ooc_growing(label, tmp, corpus):
    """A growing corpus: the first two thirds of the documents on disk, a
    template with room for all, SVI_STEPS steps with growing=True and a
    session every OOC_EVERY; a callback appends the rest and commits after
    step GROW_APPEND_AFTER.  The population rises at the next epoch
    boundary (the epochs snapshotted before the append hold the first
    documents less their holdout, those after it all documents less the
    same holdout), every ELBO is finite, the held-out documents' theta
    rows keep their initial values; the same run with ``svi.step`` armed
    to raise entering step GROW_CRASH_AT - 1, resumed from its newest
    session (whose epoch snapshots span the growth), ends bitwise at the
    uninterrupted one.  Each run grows its own copy of the first
    documents' shards."""
    from repro_torch.checkpoint import latest_session_step, load_session
    from repro_torch.core import models, vmp
    from repro_torch.core.svi import SVI
    from repro_torch.data import (ShardedCorpus, ShardedCorpusWriter,
                                  sharded_template)
    from repro_torch.testing import faults
    tokens, lengths = corpus["tokens"], corpus["lengths"]
    n_docs = len(lengths)
    grow_docs = n_docs * 2 // 3
    cut = int(lengths[:grow_docs].sum())
    cfg = svi_config(growing=True, capacity_docs=n_docs)

    def start(name):
        w = ShardedCorpusWriter(str(tmp / name), vocab=VOCAB)
        w.add_docs(tokens[:cut], lengths[:grow_docs])
        sc = w.commit()
        model = models.make("lda", alpha=ALPHA, beta=BETA, K=TOPICS, V=VOCAB)
        return w, sharded_template(model, sc, capacity_docs=n_docs), sc

    def append_after(w):
        def cb(t, elbo):
            if t == GROW_APPEND_AFTER:
                w.add_docs(tokens[cut:], lengths[grow_docs:])
                w.close()
        return cb

    t0 = time.perf_counter()
    w, tmpl, sc = start("grow_ref")
    s0 = vmp.init_state(tmpl, SEED, device="cuda")
    fit = SVI(tmpl, cfg, corpus=sc, device="cuda")
    want, want_h = fit.fit(SVI_STEPS, state=s0, callback=append_after(w),
                           checkpoint_dir=str(tmp / "ck_grow_ref"),
                           checkpoint_every=OOC_EVERY)
    fit.close()
    epochs = fit.sampler._inner.epoch_log()
    n_hold = len(fit.holdout)
    pre, post = grow_docs - n_hold, n_docs - n_hold
    grown = [s for s, n in epochs if s >= GROW_APPEND_AFTER + 2]
    pop_ok = bool(grown) and all(
        n == pre for s, n in epochs if s <= GROW_APPEND_AFTER) and all(
        n == post for s, n in epochs if s >= GROW_APPEND_AFTER + 2)
    pops = [fit.sampler.population_at(t) for t in (0, grown[0] - 1,
                                                   grown[0])] \
        if grown else []
    hold = torch.from_numpy(fit.holdout).cuda()
    held_ok = torch.equal(want.posteriors["theta"][hold],
                          s0.posteriors["theta"][hold])
    finite = bool(np.isfinite(want_h["elbo"]).all()) and bool(
        np.isfinite([v for _, v in want_h["heldout"]]).all())
    log(f"[{label}] growing: {grow_docs} documents, {n_docs - grow_docs} "
        f"appended after step {GROW_APPEND_AFTER}; epochs (start step, "
        f"population) {epochs}: population {pops[:1]} at step 0, "
        f"{pops[1:]} on each side of the first boundary after the append; "
        f"every ELBO finite: {finite}; the {n_hold} held-out documents' "
        f"theta rows at their initial values: {held_ok} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(pop_ok, f"{label}: the population did not grow from {pre} to "
          f"{post} at the epoch boundary")
    check(finite, f"{label}: a growing-run ELBO is not finite")
    check(held_ok, f"{label}: a held-out document's theta row moved")

    t0 = time.perf_counter()
    w, tmpl, sc = start("grow_crash")
    ck = str(tmp / "ck_grow")
    crash = SVI(tmpl, cfg, corpus=sc, device="cuda")
    with faults.inject("svi.step", nth=GROW_CRASH_AT):
        try:
            crash.fit(SVI_STEPS, callback=append_after(w), checkpoint_dir=ck,
                      checkpoint_every=OOC_EVERY)
            raised = False
        except faults.InjectedCrash:
            raised = True
    crash.close()
    step = latest_session_step(ck)
    sizes = [len(g) for _, g in load_session(ck).epochs]
    again = SVI(tmpl, cfg, corpus=ShardedCorpus.open(str(tmp / "grow_crash")),
                device="cuda")
    got, got_h = again.fit(SVI_STEPS - (step or 0), checkpoint_dir=ck,
                           resume_from=True)
    again.close()
    ok = raised and states_bitwise(got, want, got_h, want_h)
    log(f"[{label}] growing crash-resume: svi.step=raise@{GROW_CRASH_AT} "
        f"{'raised' if raised else 'DID NOT RAISE'}, newest session at step "
        f"{step} with epoch snapshots of {sizes} documents, resumed: "
        f"{'bitwise the uninterrupted run' if ok else 'DIFFERENT'} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(sizes == [n for _, n in epochs][:len(sizes)] and post in sizes,
          f"{label}: the session lost the epoch snapshots across the growth")
    check(ok, f"{label}: growing crash-resume is not bitwise")
    return {"epochs": epochs, "populations": pops, "session_epochs": sizes,
            "session_step": step, "elbo_trace": want_h["elbo"],
            "heldout": want_h["heldout"]}


def ooc_vmp_checkpoints(label, tmp, prog, report):
    """``run_inference`` on the main path's program with a checkpoint every
    half of its steps: the first half, then a call that resumes from the
    directory for the rest; the whole trace and the final posteriors must
    be the main path's (phase 5's digest)."""
    from repro_torch.core import runtime, vmp
    ck = str(tmp / "ck_vmp")
    total = len(report["elbo_trace"])
    half = total // 2
    t0 = time.perf_counter()
    _, first = runtime.run_inference(prog, half, seed=SEED,
                                     checkpoint_every=half,
                                     checkpoint_dir=ck, device="cuda")
    state, second = runtime.run_inference(prog, total - half, seed=SEED,
                                          checkpoint_every=half,
                                          checkpoint_dir=ck, device="cuda")
    digest = output_digest(vmp.state_to_numpy(state)[0], first + second)
    ok = first + second == report["elbo_trace"] and digest == report["digest"]
    log(f"[{label}] VMP checkpoints: {half} steps, then {total - half} "
        f"resumed from step {int(state.step) - len(second)}: sha256 "
        f"{digest} {'==' if ok else '!='} the main path's "
        f"({time.perf_counter() - t0:.1f} s)")
    check(ok, f"{label}: VMP checkpoint resume is not bitwise the main path")
    return digest


def phase_lda_ooc(report, corpus, prog):
    """The main path's LDA out of core: the corpus written to shards in a
    temporary directory (removed at exit) and streamed through
    ``SVI(sharded_template(...), corpus=, prefetch=True)``.  The 30-step fit
    must be bitwise ``lda_svi``'s; its step's time split beside
    ``lda_svi``'s; crash-resume in one process and after a SIGKILL; a
    growing corpus and its resume; VMP checkpoints; ``zstats`` and the Elog
    pass at one out-of-core batch against their plain versions."""
    import tempfile
    from repro_torch.core import models, vmp
    from repro_torch.core.svi import SVI
    from repro_torch.data import sharded_template, write_sharded_corpus
    from repro_torch.kernels import ops
    label = "lda_ooc"
    out = report[label] = {}
    with tempfile.TemporaryDirectory(prefix="lda_ooc-") as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        sc = write_sharded_corpus(corpus, str(tmp / "corpus"))
        write_s = time.perf_counter() - t0
        model = models.make("lda", alpha=ALPHA, beta=BETA, K=TOPICS, V=VOCAB)
        tmpl = sharded_template(model, sc)
        log(f"[{label}] {sc.n_docs} documents, {sc.n_tokens} tokens in "
            f"{sc.n_shards} shards ({sc.disk_bytes} bytes) written in "
            f"{write_s:.2f} s")
        cfg = svi_config()
        fit = SVI(tmpl, cfg, corpus=sc, device="cuda")
        s0 = vmp.init_state(tmpl, SEED, device="cuda")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = fit.fit(SVI_STEPS, state=s0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        svi_fit_checks(label, cfg, hist, counts, "zstats", SVI_STEPS)
        held = [v for _, v in hist["heldout"]]
        digest = output_digest(vmp.state_to_numpy(state)[0],
                               hist["elbo"] + held)
        want = report["lda_svi"]["digest"]
        log(f"[{label}] fit({SVI_STEPS}) out of core {fit_s:.2f} s; sha256 "
            f"{digest} {'==' if digest == want else '!='} lda_svi's; peak "
            f"host buffers {fit.sampler.peak_buffer_bytes} bytes (two "
            f"batches with their owner plans); shard bytes read "
            f"{sc.bytes_read} in {sc.reads} reads")
        check(digest == want, f"{label}: the out-of-core fit is not bitwise "
              f"lda_svi's")
        entries = svi_flat_kernels(label, fit, state, counts)
        out.update(svi_step_times(label, fit, state, report["device"],
                                  warm=1))
        fit.close()
        res = report["lda_svi"]
        log(f"[{label} vs lda_svi] {report['device']}: step "
            f"{out['step_ms']:.2f} against {res['step_ms']:.2f} ms, "
            f"{out['tokens_per_s']:.4e} against {res['tokens_per_s']:.4e} "
            f"tokens/s, device {out['trace']['busy_ms']:.3f} against "
            f"{res['trace']['busy_ms']:.3f} ms a step, idle share "
            f"{out['idle_share']} against {res['idle_share']}")
        out.update(elbo_trace=hist["elbo"], heldout=hist["heldout"],
                   launches=counts, fit_s=fit_s, digest=digest,
                   write_s=write_s, disk_bytes=sc.disk_bytes,
                   peak_buffer_bytes=fit.sampler.peak_buffer_bytes,
                   bytes_read=sc.bytes_read, reads=sc.reads)
        del fit, state, s0
        out["sessions"] = ooc_sessions(label, tmp, tmpl, str(tmp / "corpus"))
        out["growing"] = ooc_growing(label, tmp, corpus)
        out["vmp_checkpoint_digest"] = ooc_vmp_checkpoints(label, tmp, prog,
                                                           report)
    return entries


def phase_segment_svi(label, m, report, bitwise_vmp):
    """SVI of a segment-latent path: with ``bitwise_vmp`` first one step at
    |B| = G against VMP; padding invariance on batch 0; SVI_SEGMENT_STEPS
    padded steps with a held-out evaluation (the reference's
    ``test_slda_minibatch_runs`` at the path's widths), their launch counts
    set to 0 just before and read just after; then ``zstats_zmap`` and its
    phase 1 alone (``zmap_logits``) against their plain versions at one
    padded batch's inputs, whose padding tokens map to instance 0 and whose
    padding instances hold no tokens.  Returns the path's kernels entry and
    the fit's final state."""
    from repro_torch.core import vmp
    from repro_torch.core.svi import SVI
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ops, ref
    prog = m.compile()
    name = f"{label}_svi"
    if bitwise_vmp:
        svi_equals_vmp(name, prog)
    cfg = svi_config(holdout_every=SVI_SEGMENT_STEPS)
    svi = SVI(prog, cfg, device="cuda")
    s0 = vmp.init_state(prog, SEED, device="cuda")
    _, _, worst = svi_pad_check(name, prog, svi, s0)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = svi.fit(SVI_SEGMENT_STEPS, state=s0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"[{name}] fit({SVI_SEGMENT_STEPS}) of batches of "
        f"{svi.sampler.batch_size} documents: {fit_s:.2f} s")
    svi_fit_checks(name, cfg, hist, counts, "zstats_zmap", SVI_SEGMENT_STEPS)
    check(counts["zstats"] == 0, f"{name}: the flat zstats launched")

    log(f"[kernels vs plain] {name}: one batch's inputs (padded, masked)")
    n_tok, _, args, plan, spec = svi_batch_inputs(svi, state,
                                                  SVI_SEGMENT_STEPS)
    prior, _, children, zmask = args
    check(all(c.zmap is not None for c in children),
          f"{name}: a child of the segment latent has no zmap")
    n_z, k = spec.n, spec.k
    n_real = int(zmask.sum())
    n_parts = sum(int(plan.streams[f"latent{j}", "fstart"][-1])
                  for j in range(len(plan.by_latent)))
    err = compare_zstats(f"{name} batch", fzm.zstats_zmap(*args, plan=plan),
                         ref.zstats(*args), name="zstats_zmap")
    lerr = compare("zmap_logits", f"{name} batch",
                   fzm.zmap_logits(children, n_z, k, plan=plan),
                   ref.zmap_logits(children, n_z, k),
                   dict(rtol=ZSTATS_TOL["rtol"], atol=ZSTATS_TOL["atol"]))
    t_z = time_ms(lambda: fzm.zstats_zmap(*args, plan=plan), reps=20)
    t_zp = time_ms(lambda: ref.zstats(*args), reps=3)
    bms, by = work_bound("zstats_zmap", *args)
    entry = kernel_entry(name, "zstats_zmap", "cuda",
                         "src/repro_torch/kernels/csrc/zstats.cu",
                         "src/repro/kernels/fused_zmap.py:236",
                         counts["zstats_zmap"], err, t_z, t_zp, bms, by)
    log(f"  zstats_zmap            {t_z:9.4f} ms  plain {t_zp:9.4f} ms  "
        f"bound {bms:8.4f} ms ({by})  launches {counts['zstats_zmap']} "
        f"({n_real} of {n_z} instances real, {n_tok} tokens, {n_parts} "
        f"partial rows); zmap_logits at the same inputs max_abs {lerr:.3e} "
        f"(the step does not launch it apart)")
    del args, plan, children, prior
    report[name] = dict(elbo_trace=hist["elbo"], heldout=hist["heldout"],
                        launches=counts, fit_s=fit_s, pad_max_abs=worst,
                        zstats_zmap_ms=t_z, zmap_logits_max_abs=lerr,
                        partial_rows=n_parts)
    return [entry], state


# ---------------------------------------------------------------------------
# the query layer: the lda_svi fit frozen, folded in and served; SLDA
# fold-in with bindings; the Gibbs backend on the main path's model
# ---------------------------------------------------------------------------

# the server's load, assumed (no source gives request sizes or clients):
# 256 requests of 1-4 held-out documents from 8 client threads, batched up
# to 64 documents (docs/query_serving.md's max_batch_docs); a 64-document score timed cold and
# warm, and WARM_SCORES warm scores under the profiler
QUERY_REQUESTS, QUERY_CLIENTS, QUERY_BATCH_DOCS = 256, 8, 64
WARM_SCORES = 3
# the Gibbs phase: 40 sweeps, half of them burn-in, 5% held out
GIBBS_STEPS, GIBBS_HOLDOUT = 40, 0.05
QUERY_RTOL = 1e-5


def docs_payload(corpus, docs):
    """(tokens, lengths) of the given documents, back to back."""
    offs = np.concatenate([[0], np.cumsum(corpus["lengths"])])
    vals = np.concatenate([corpus["tokens"][offs[d]:offs[d + 1]]
                           for d in docs])
    return vals, corpus["lengths"][docs]


@contextlib.contextmanager
def recording(*names):
    """While the block runs, every call of the port's dispatch functions
    ``names`` (``kernels/ops.py``) passes through unchanged, and the last
    call for each shape of its first table is kept: ``{(name, shape):
    (args, kwargs, output)}``.  These are the inputs that the port's own
    code hands the kernels; nothing launches twice."""
    from repro_torch.kernels import ops
    calls, orig = {}, {n: getattr(ops, n) for n in names}

    def wrap(name):
        def call(*a, **kw):
            out = orig[name](*a, **kw)
            first = a[0][0].elog if name == "zmap_logits" else a[0]
            calls[name, tuple(first.shape)] = (a, kw, out)
            return out
        return call
    for n in names:
        setattr(ops, n, wrap(n))
    try:
        yield calls
    finally:
        for n, f in orig.items():
            setattr(ops, n, f)


def same(a, b):
    """Bitwise equality of two outputs (tensors, or tuples of them)."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


def replayed(label, calls):
    """Each recorded call (:func:`recording`) made again on its recorded
    inputs must give its recorded output bitwise (the inputs still hold
    what the kernel read), and the zstats call's prior table must differ
    from row to row (a local pass after the prior's).  Returns the zstats
    call as (table_prior, prior_rows, children, zmask) and its plan."""
    from repro_torch.kernels import ops
    for (name, shape), (a, kw, out) in calls.items():
        check(same(getattr(ops, name)(*a, **kw), out),
              f"{label}: {name} {shape} made again on its recorded inputs "
              f"differs from the recorded call")
    (a, kw, _), = [v for (n, _), v in calls.items() if n == "zstats"]
    check(not torch.equal(a[0].amin(0), a[0].amax(0)),
          f"{label}: the recorded zstats call reads the prior's rows only")
    return (*a, kw.get("zmask")), kw.get("plan")


def flat_recorded(label, calls, counts, rows):
    """The kernels of a flat latent's fold-in at the inputs it handed them
    (:func:`recording` of one score), each call :func:`replayed`: ``zstats``
    at the last step body, the Elog pass on every table (timed on the theta
    rows that zstats call read) and ``zstep`` on the per-group pass's
    logits, each held against its plain version and timed beside its
    bound: the kernels-line entries of path ``label`` with its launch
    ``counts``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import vmp_zstep as zs
    args, plan = replayed(label, calls)
    theta = calls["dirichlet_expectation", tuple(args[0].shape)][0][0]
    for (name, shape), (a, kw, out) in calls.items():
        if name == "dirichlet_expectation" and a[0] is not theta:
            compare(name, f"{label} {shape}", out,
                    de_plain(a[0], kw.get("transpose", False)), DE_TOL)
    (logits,), _, (r, lse) = [v for (n, _), v in calls.items()
                              if n == "zstep"][0]
    rp, lp = ref.zstep(logits)
    s_err = max(compare("zstep", f"{label} r {tuple(logits.shape)}", r, rp,
                        ZSTEP_TOL),
                compare("zstep", f"{label} lse", lse, lp,
                        dict(rtol=1e-5, atol=1e-5)))
    t_s = time_ms(lambda: zs.zstep(logits), reps=20)
    t_sp = time_ms(lambda: ref.zstep(logits), reps=5)
    zstep = ("zstep", "triton", "src/repro_torch/kernels/vmp_zstep.py",
             "src/repro/kernels/vmp_zstep.py:40", t_s, t_sp,
             work_bound("zstep", logits), s_err)
    return flat_kernel_entries(label, args, plan, theta, counts, rows,
                               extra=(zstep,))


def score_split(fold, payloads):
    """Score each payload on ``fold`` and return the mean ms of each part
    ``FoldIn.times`` records (compile, slice, plan, h2d, run) and of the
    whole, on the host clock."""
    fold.times = []
    for vals, lengths in payloads:
        t0 = time.perf_counter()
        fold.score(vals, lengths=lengths)
        fold.times[-1]["total"] = (time.perf_counter() - t0) * 1e3
    parts, fold.times = fold.times, None
    return {k: float(np.mean([p[k] for p in parts])) for k in parts[0]}


def phase_query(report, m, prog, state, holdout, corpus, heldout_svi):
    """The lda_svi fit frozen into a Posterior (``InferenceResult.freeze``),
    saved and loaded bitwise; its held-out documents folded in at exact
    caps bitwise ``svi.heldout_elbo``; a QueryServer answering 256 requests
    from 8 client threads (launch counts set to 0 just before the fold-in
    and read after the server stops), each response held against the same
    documents scored alone; one credible-interval row against
    ``betaincinv``; cold and warm scores of 64 documents split host/device;
    the kernels against their plain versions at the inputs that the
    held-out fold-in (checked only) and a warm 64-document score (the
    path's entries) handed them.  Returns the entries and the loaded
    artifact."""
    import tempfile
    import threading
    from scipy.special import betaincinv
    from repro_torch.core import svi as svi_mod
    from repro_torch.core.engine import InferenceResult
    from repro_torch.kernels import ops
    from repro_torch.query import (FoldIn, FoldInConfig, Posterior,
                                   QueryClient, QueryServer)
    label = "query"
    out = report[label] = {}
    posts = {n: p.cpu().numpy() for n, p in state.posteriors.items()}
    res = InferenceResult("svi", posts, [], [(SVI_STEPS - 1, heldout_svi)],
                          {"steps": SVI_STEPS})
    t0 = time.perf_counter()
    post = res.freeze(m, program=prog)
    with tempfile.TemporaryDirectory(prefix="query-") as tmp:
        post.save(tmp)
        loaded = Posterior.load(tmp)
    io_s = time.perf_counter() - t0
    ok = all(np.array_equal(loaded.posteriors[n], post.posteriors[n])
             and np.array_equal(post.posteriors[n], posts[n])
             for n in posts) and (loaded.local, loaded.observed) == \
        (("theta",), ("x",))
    log(f"[{label}] freeze + save + load of phi {posts['phi'].shape} and "
        f"theta {posts['theta'].shape}: {io_s:.2f} s, round trip "
        f"{'bitwise' if ok else 'DIFFERENT'}")
    check(ok, f"{label}: the artifact's save/load round trip is not bitwise")

    member = np.zeros(len(corpus["lengths"]), bool)
    member[holdout] = True
    hm = member[corpus["doc_ids"]]
    h_vals = corpus["tokens"][hm]
    h_segs = np.searchsorted(holdout, corpus["doc_ids"][hm])
    exact = FoldIn(loaded, FoldInConfig(local_iters=10, bucket=None),
                   device="cuda")
    fold = FoldIn(loaded, FoldInConfig(local_iters=10), device="cuda")
    rng = np.random.default_rng(SEED)
    requests = []
    for _ in range(QUERY_REQUESTS):
        docs = rng.choice(holdout, size=int(rng.integers(1, 5)),
                          replace=False)
        requests.append(docs_payload(corpus, docs))
    responses = [None] * QUERY_REQUESTS

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = exact.score(h_vals, segment_ids=h_segs)
    held_s = time.perf_counter() - t0
    with QueryServer(fold, max_batch_docs=QUERY_BATCH_DOCS) as srv:
        t_srv = time.perf_counter()

        def client(i):
            c = QueryClient(srv)
            for j in range(i, QUERY_REQUESTS, QUERY_CLIENTS):
                responses[j] = c.score(requests[j][0],
                                       lengths=requests[j][1])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(QUERY_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        srv_s = time.perf_counter() - t_srv
        stats = srv.stats()
    counts = ops.launch_counts()
    check(all(r is not None for r in responses),
          f"{label}: a client thread got no response")

    want = svi_mod.heldout_elbo(prog, state, holdout, 10)
    log(f"[{label}] fold-in of the {len(holdout)} held-out documents "
        f"({got.n_tokens} tokens, exact caps, 10 local passes) in "
        f"{held_s:.2f} s: per-token LL {got.per_token_ll!r}, "
        f"svi.heldout_elbo {want!r}: "
        f"{'bitwise' if got.per_token_ll == want else 'DIFFERENT'}")
    check(got.per_token_ll == want,
          f"{label}: fold-in is not bitwise svi.heldout_elbo")
    rel = abs(float(got.doc_ll.astype(np.float64).sum()) - got.elbo) \
        / abs(got.elbo)
    mix_err = float(np.abs(got.mixtures["theta"].sum(-1, dtype=np.float64)
                           - 1).max())
    log(f"[{label}] doc_ll sums to the ELBO within {rel:.2e} relative "
        f"(tol {QUERY_RTOL}); mixtures {got.mixtures['theta'].shape} sum to "
        f"1 within {mix_err:.2e}")
    check(rel <= QUERY_RTOL and got.doc_ll.shape == (len(holdout),)
          and np.isfinite(got.doc_ll).all(),
          f"{label}: doc_ll does not decompose the ELBO")
    check(mix_err <= QUERY_RTOL, f"{label}: mixtures do not sum to 1")
    with recording("zstats", "dirichlet_expectation", "zstep") as calls:
        again = exact.score(h_vals, segment_ids=h_segs)
    ok = again.elbo == got.elbo and np.array_equal(again.doc_ll, got.doc_ll)
    log(f"[{label}] two scores of one payload: "
        f"{'bitwise' if ok else 'DIFFERENT'}")
    check(ok, f"{label}: two scores of one payload differ")
    log(f"[kernels vs plain] {label}: the held-out fold-in's own inputs "
        f"(exact caps; its entries are checked, not kept)")
    flat_recorded(f"{label} held-out", calls, counts,
                  "the held-out theta rows")
    del calls

    n_req = sum(len(r[1]) for r in requests)
    log(f"[{label}] server: {QUERY_REQUESTS} requests ({n_req} documents) "
        f"from {QUERY_CLIENTS} client threads in {srv_s:.2f} s: "
        f"{stats['docs_per_s']:.1f} docs/s, {stats['tokens_per_s']:.4e} "
        f"tokens/s, p50 {stats['latency_p50_ms']:.2f} ms, p95 "
        f"{stats['latency_p95_ms']:.2f} ms, {stats['batches']} batches of "
        f"{stats['mean_batch_docs']:.2f} documents on average, "
        f"{stats['compiled_buckets']} buckets")
    log(f"[{label}] launches (held-out fold-in + server): {counts}")
    check(stats["requests"] == QUERY_REQUESTS and stats["docs"] == n_req,
          f"{label}: stats() counts {stats['requests']} requests, "
          f"{stats['docs']} documents")
    for name in ("zstats", "dirichlet_expectation", "zstep"):
        check(counts[name] > 0, f"{label}: {name} did not launch")
    check(counts["zstats_zmap"] == 0, f"{label}: zstats_zmap launched")
    worst = 0.0
    for (vals, lengths), r in zip(requests, responses):
        alone = fold.score(vals, lengths=lengths)
        d = np.abs(r.doc_ll.astype(np.float64) - alone.doc_ll) \
            / np.abs(alone.doc_ll)
        worst = max(worst, float(d.max()))
    log(f"[{label}] each response against its documents scored alone: "
        f"max relative difference {worst:.2e} (tol {QUERY_RTOL})")
    check(worst <= QUERY_RTOL, f"{label}: a response differs from its "
          f"documents scored alone")
    multi = requests[0] if len(requests[0][1]) > 1 else docs_payload(
        corpus, holdout[:3])
    with QueryServer(fold, max_batch_docs=QUERY_BATCH_DOCS) as srv:
        r = QueryClient(srv).score(multi[0], lengths=multi[1])
    direct = fold.score(multi[0], lengths=multi[1])
    ok = np.array_equal(r.doc_ll, direct.doc_ll)
    log(f"[{label}] a {len(multi[1])}-document request served alone: "
        f"{'bitwise' if ok else 'DIFFERENT'} its direct score")
    check(ok, f"{label}: a served request is not bitwise its direct score")

    t0 = time.perf_counter()
    lo, hi = loaded.credible_interval("phi", 0.9, rows=0)
    ci_s = time.perf_counter() - t0
    a = loaded.posteriors["phi"][:1].astype(np.float64)
    b = a.sum(-1, keepdims=True) - a
    ci_err = max(float(np.abs(lo - betaincinv(a, b, 0.05)).max()),
                 float(np.abs(hi - betaincinv(a, b, 0.95)).max()))
    log(f"[{label}] credible_interval of phi row 0 ({a.shape[1]} cells, 90%)"
        f" in {ci_s:.2f} s: max |bisection - betaincinv| {ci_err:.2e} "
        f"(tol 1e-12)")
    check(ci_err <= 1e-12, f"{label}: a credible interval is off "
          f"betaincinv")

    # cold and warm scores of 64 documents, and the device under the
    # profiler over warm ones
    pay = [docs_payload(corpus, docs) for docs in np.resize(
        holdout, (WARM_SCORES + 2) * QUERY_BATCH_DOCS).reshape(
            -1, QUERY_BATCH_DOCS)]
    timed = FoldIn(loaded, FoldInConfig(local_iters=10), device="cuda")
    cold = score_split(timed, pay[:1])
    warm = score_split(timed, pay[1:2])

    def run():
        for vals, lengths in pay[2:]:
            timed.score(vals, lengths=lengths)
    trace = profile_steps(run, WARM_SCORES, label=f"{label} trace")
    idle = (1 - trace["busy_ms"] / trace["step_ms"]
            if trace["busy_ms"] > 0 else None)
    tok = float(np.mean([p[1].sum() for p in pay]))
    for name, t in (("cold", cold), ("warm", warm)):
        host = t["compile"] + t["slice"] + t["plan"] + t["h2d"]
        log(f"[{label} times] {report['device']}: {name} score of "
            f"{QUERY_BATCH_DOCS} documents (~{tok:.0f} tokens) "
            f"{t['total']:.2f} ms: compile {t['compile']:.2f}, slice "
            f"{t['slice']:.2f}, plan {t['plan']:.2f}, H2D {t['h2d']:.2f} ms "
            f"({host:.2f} ms of host work before the kernels), the scorer "
            f"to results on the host {t['run']:.2f} ms")
    log(f"[{label} times] warm scores under the profiler: device "
        f"{trace['busy_ms']:.3f} ms a score of {trace['step_ms']:.2f}, idle "
        f"share {'not measured' if idle is None else f'{idle:.3f}'}")
    log(f"[kernels vs plain] {label}: the inputs of a warm score of "
        f"{QUERY_BATCH_DOCS} documents (a pow2 bucket, padded and masked)")
    with recording("zstats", "dirichlet_expectation", "zstep") as calls:
        timed.score(pay[0][0], lengths=pay[0][1])
    entries = flat_recorded(label, calls, counts, "the request's theta rows")
    out.update(heldout_per_token=got.per_token_ll, heldout_svi=want,
               heldout_s=held_s, server=stats, server_s=srv_s,
               launches=counts, response_max_rel=worst,
               credible_interval_err=ci_err, credible_interval_s=ci_s,
               cold=cold, warm=warm, trace=trace, idle_share=idle)
    return entries, loaded


# the gateway phase: benchmarks/bench_gateway.py's protocol at the NYTimes
# widths; each tenant runs the bench's script once on each artifact, with
# its interval on a theta row (a phi row's 102,660 cells take seconds of
# float64 bisection, timed once apart from the load)
GATEWAY_TENANTS, GATEWAY_TOP_K, GATEWAY_REPS = 4, 128, 2
GATEWAY_SCRIPT = """
    TOPICS OF phi TOP 10 USING ARTIFACT '{a}';
    SIMILARITY BETWEEN phi[0] AND phi[1] USING hellinger
        USING ARTIFACT '{a}';
    CREDIBLE INTERVAL 0.9 FOR theta[{row}] USING ARTIFACT '{a}';
    PREDICT LL FOR DOCS $batch USING ARTIFACT '{a}'
"""
GATEWAY_KINDS = {
    "topics": "TOPICS OF phi TOP 10 USING ARTIFACT '{a}'",
    "similarity": "SIMILARITY BETWEEN phi[0] AND phi[1] USING hellinger "
                  "USING ARTIFACT '{a}'",
    "credible": "CREDIBLE INTERVAL 0.9 FOR theta[{row}] USING ARTIFACT '{a}'",
    "predict": "PREDICT LL FOR DOCS $batch USING ARTIFACT '{a}'",
}


def gateway_docs(corpus, seed, n=3):
    """The bench's payload: ``n`` corpus documents drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    vals, lengths = docs_payload(corpus, rng.integers(
        0, len(corpus["lengths"]), n))
    return {"values": vals, "lengths": lengths}


def compacted_bitwise(a, b):
    """Two compacted artifacts hold the same compact tables (the bf16 ones
    by their bits), dense tables and error record."""
    def bits(t):
        return t.view(torch.int16).numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
    return (sorted(a.compact_tables) == sorted(b.compact_tables)
            and all(np.array_equal(bits(v), bits(b.compact_tables[n]))
                    for n, v in a.compact_tables.items())
            and sorted(a.posteriors) == sorted(b.posteriors)
            and all(np.array_equal(v, b.posteriors[n])
                    for n, v in a.posteriors.items())
            and a.compaction == b.compaction
            and a.error_bound == b.error_bound)


def phase_gateway(report, post, corpus):
    """``benchmarks/bench_gateway.py``'s protocol over lda_svi's frozen
    posterior (``post``, phi 100 x 102,660): a replica compacted at top-k
    128, bitwise across save/load, its dense tables on the card bitwise the
    host's compaction; both registered under one ``Gateway`` on the card;
    four tenant threads each running the bench's script (TOPICS,
    SIMILARITY, CREDIBLE INTERVAL on a theta row, PREDICT of 3 corpus
    documents) once on each artifact, with the launch counts set to 0 just
    before and read just after; every PREDICT within 1e-5 of its documents
    scored through ``FoldIn.score`` alone; ``stats()`` counting every
    query, no tenant error; queries/s and p95 from the gateway's stats tree;
    ms per query kind on each artifact and one phi-row interval; EXPLAIN's
    route equal to the executed route for every statement of one tenant's
    scripts, and its kernel routes the routes that a PREDICT's launches
    took, on each artifact; ``zstats``, the Elog pass
    and ``zstep`` at the inputs one PREDICT handed them, replayed bitwise
    and held against their plain versions (the path's entries)."""
    import tempfile
    import threading
    from repro_torch.gateway import Gateway, compact_posterior, parse_script
    from repro_torch.gateway.plan import ExplainQuery
    from repro_torch.kernels import ops
    from repro_torch.query import Posterior
    label = "gateway"
    out = report[label] = {}
    n_theta = post.posteriors["theta"].shape[0]

    t0 = time.perf_counter()
    lite = compact_posterior(post, top_k=GATEWAY_TOP_K)
    compact_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="gateway-") as tmp:
        lite.save(tmp)
        loaded = Posterior.load(tmp)
    ok = compacted_bitwise(loaded, lite)
    log(f"[{label}] compact_posterior(top_k={GATEWAY_TOP_K}) in "
        f"{compact_s:.2f} s: {lite.nbytes_full()} bytes full, "
        f"{lite.nbytes_compact()} compact ({lite.compression_ratio():.2f}x), "
        f"error_bound {lite.error_bound!r}; save/load "
        f"{'bitwise' if ok else 'DIFFERENT'}")
    check(ok, f"{label}: the compacted artifact is not bitwise across "
          f"save/load")

    with Gateway(max_delay_s=0.002, device="cuda") as gw:
        gw.register("full", post, version="f0")
        gw.register("lite", loaded, version="l0")
        on_card = {n: t.cpu().numpy() for n, t in
                   gw.registry.get("lite").foldin._globals.items()}
        ok = all(np.array_equal(v, lite.posteriors[n])
                 for n, v in on_card.items())
        log(f"[{label}] the lite artifact's tables on the card "
            f"{sorted(on_card)}: {'bitwise' if ok else 'DIFFERENT'} the "
            f"host's compact_posterior")
        check(ok, f"{label}: the card's lite tables are not the host's "
              f"compaction")
        # warm both artifacts' buckets out of the load, as the bench does
        for aid in ("full", "lite"):
            gw.query(GATEWAY_KINDS["predict"].format(a=aid),
                     params={"batch": gateway_docs(corpus, 0)}, timeout_s=120)

        results, errors = {}, []

        def tenant_load(t):
            rng = np.random.default_rng(t)
            for i, aid in enumerate(("full", "lite")):
                params = {"batch": gateway_docs(corpus, t * 97 + i)}
                script = GATEWAY_SCRIPT.format(a=aid,
                                               row=int(rng.integers(n_theta)))
                try:
                    results[t, aid] = (params["batch"], gw.run_script(
                        script, params=params, tenant=f"tenant-{t}",
                        timeout_s=120), script)
                except Exception as e:
                    errors.append((t, aid, repr(e)))

        threads = [threading.Thread(target=tenant_load, args=(t,))
                   for t in range(GATEWAY_TENANTS)]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        stats = gw.stats()
        check(not errors, f"{label}: tenant errors {errors[:3]}")
        tenants = {t: w for t, w in stats["tenants"].items()
                   if t.startswith("tenant-")}
        n_queries = GATEWAY_TENANTS * 2 * len(GATEWAY_KINDS)
        served = sum(w["served"] for w in tenants.values())
        bad = sum(w["errors"] + w["rejected"] for w in tenants.values())
        p95 = max(w["latency_p95_ms"] for w in tenants.values())
        occ = {a: w.get("batch_occupancy")
               for a, w in stats["artifacts"].items()}
        log(f"[{label}] {GATEWAY_TENANTS} tenants x 2 scripts: {served} "
            f"queries in {wall:.2f} s, {served / wall:.2f} queries/s, p95 "
            f"{p95:.2f} ms (the gateway's stats tree), PREDICT batch "
            f"occupancy {occ}; launches {counts}")
        check(len(tenants) == GATEWAY_TENANTS and served == n_queries
              and bad == 0, f"{label}: stats() counts {served} served of "
              f"{n_queries}, {bad} errors or rejections")
        for name in ("zstats", "dirichlet_expectation", "zstep"):
            check(counts[name] > 0, f"{label}: {name} did not launch")
        check(counts["zstats_zmap"] == 0, f"{label}: zstats_zmap launched")
        worst, gap, gap_rel = 0.0, 0.0, 0.0
        for (t, aid), (docs, rs, _) in sorted(results.items()):
            r = rs[-1]
            check(r.kind == "predict" and r.artifact == aid,
                  f"{label}: tenant {t}'s last answer is {r.kind}")
            alone = gw.registry.get(aid).foldin.score(
                docs["values"], lengths=docs["lengths"])
            # a served answer's per-token LL is its documents' LL over
            # their tokens (QueryServer), as it is here
            ptl = float(alone.doc_ll.sum()) / alone.n_tokens
            d = np.abs(r.value["doc_ll"].astype(np.float64) - alone.doc_ll) \
                / np.abs(alone.doc_ll)
            worst = max(worst, float(d.max()),
                        abs(r.value["per_token_ll"] - ptl) / abs(ptl))
            g = abs(float(alone.doc_ll.astype(np.float64).sum())
                    - alone.elbo)
            gap, gap_rel = max(gap, g), max(gap_rel, g / abs(alone.elbo))
            check((r.error_bound is None) == (aid == "full"),
                  f"{label}: {aid} answered with error_bound "
                  f"{r.error_bound}")
        log(f"[{label}] each gateway PREDICT (its documents' LL and "
            f"per-token LL) against its documents scored through "
            f"FoldIn.score alone: max relative difference {worst:.2e} "
            f"(tol {QUERY_RTOL}); FoldIn's fused ELBO against the sum of "
            f"its documents' LL: max |gap| {gap:.4f} nats, {gap_rel:.2e} "
            f"of the ELBO (tol {QUERY_RTOL})")
        check(worst <= QUERY_RTOL, f"{label}: a PREDICT differs from "
              f"FoldIn.score")
        check(gap_rel <= QUERY_RTOL, f"{label}: FoldIn's ELBO is not the "
              f"sum of its documents' LL")

        # ms per query kind, full against lite, on one payload per rep
        kind_ms, lls = {}, {}
        for aid in ("full", "lite"):
            for kind, text in GATEWAY_KINDS.items():
                t0 = time.perf_counter()
                for i in range(GATEWAY_REPS):
                    r = gw.query(text.format(a=aid, row=i),
                                 params={"batch": gateway_docs(corpus, i)},
                                 timeout_s=120)
                kind_ms[aid, kind] = (time.perf_counter() - t0) \
                    / GATEWAY_REPS * 1e3
                if kind == "predict":
                    lls[aid] = r.value["per_token_ll"]
        for kind in GATEWAY_KINDS:
            log(f"[{label} times] {report['device']}: {kind:<10} full "
                f"{kind_ms['full', kind]:9.2f} ms, lite "
                f"{kind_ms['lite', kind]:9.2f} ms a query (mean of "
                f"{GATEWAY_REPS})")
        dev = abs(lls["lite"] - lls["full"])
        log(f"[{label}] PREDICT per-token LL full {lls['full']!r}, lite "
            f"{lls['lite']!r}: |lite - full| {dev:.6f} nats/token beside "
            f"error_bound {lite.error_bound:.6f}")
        t0 = time.perf_counter()
        r = gw.query("CREDIBLE INTERVAL 0.9 FOR phi[0] USING ARTIFACT 'full'")
        ci_s = time.perf_counter() - t0
        check(r.value["lo"].shape == (VOCAB,)
              and bool((r.value["lo"] <= r.value["hi"]).all()),
              f"{label}: a phi-row interval is malformed")
        log(f"[{label} times] CREDIBLE INTERVAL 0.9 FOR phi[0] ({VOCAB} "
            f"cells): {ci_s:.2f} s")

        # EXPLAIN against the execution: every statement of tenant 0's two
        # scripts (every kind on both artifacts) against its answer in the
        # load, and each artifact's PREDICT run alone, its kernel routes
        # against the routes that its launches took
        for aid in ("full", "lite"):
            docs, rs, script = results[0, aid]
            for q, r in zip(parse_script(script), rs):
                ex = gw.query(ExplainQuery(q), params={"batch": docs})
                check(ex.route == r.route
                      and f"route: {r.route}" in ex.value["text"],
                      f"{label}: EXPLAIN {q.to_text()} names {ex.route!r}, "
                      f"the execution {r.route!r}")
            q = GATEWAY_KINDS["predict"].format(a=aid)
            ex = gw.query(f"EXPLAIN {q}", params={"batch": docs})
            ops.reset_launch_counts()
            ran = gw.query(q, params={"batch": docs}, timeout_s=120)
            torch.cuda.synchronize()
            routes = ops.route_counts()
            check(ex.route == ran.route, f"{label}: EXPLAIN {q} names "
                  f"{ex.route!r}, the execution {ran.route!r}")
            named = explained_routes(ex.value["text"])
            check(named == {"z": EXPECTED_ROUTE["main"]},
                  f"{label}: EXPLAIN names kernel routes {named}")
            route_check(label, f"EXPLAIN PREDICT on {aid}",
                        parse_route(named["z"]), routes)
        log(f"[{label}] EXPLAIN's route equals the executed route for "
            f"every kind on both artifacts")

        log(f"[kernels vs plain] {label}: the inputs of one gateway PREDICT "
            f"on the full artifact")
        with recording("zstats", "dirichlet_expectation", "zstep") as calls:
            gw.query(GATEWAY_KINDS["predict"].format(a="full"),
                     params={"batch": gateway_docs(corpus, 11)},
                     timeout_s=120)
        entries = flat_recorded(label, calls, counts,
                                "the request's theta rows")
        del calls
    out.update(bytes_full=lite.nbytes_full(),
               bytes_compact=lite.nbytes_compact(),
               error_bound=lite.error_bound, compact_s=compact_s,
               load_s=wall, queries=served, queries_per_s=served / wall,
               p95_ms=p95, batch_occupancy=occ, launches=counts,
               predict_max_rel=worst, elbo_doc_ll_gap=gap,
               elbo_doc_ll_gap_rel=gap_rel,
               kind_ms={f"{a}/{k}": v for (a, k), v in kind_ms.items()},
               predict_ll=lls, predict_ll_deviation=dev,
               phi_row_interval_s=ci_s, stats=stats)
    return entries


def slda_payloads(corpus, n_docs=4):
    """Two payloads (A, B) of ``n_docs`` held-out documents each, cut into
    sentences as the SLDA path cuts them: (tokens, sentence of each token,
    document of each sentence) per payload."""
    from repro_torch.data.pipeline import holdout_split
    _, hold = holdout_split(len(corpus["lengths"]), 0.05, SEED)
    out = []
    for docs in (hold[:n_docs], hold[n_docs:2 * n_docs]):
        vals, lengths = docs_payload(corpus, docs)
        sub = {"lengths": lengths,
               "doc_ids": np.repeat(np.arange(len(docs)), lengths)}
        tok_sent, sent_doc = sentences(sub)
        out.append((vals, tok_sent, sent_doc))
    return out


def phase_slda_query(report, m, state, payloads):
    """SLDA fold-in with bindings on the slda_svi fit, frozen: payload A,
    then B, on one FoldIn (B warm in A's bucket) with the launch counts set
    to 0 just before and read just after; B again on a cold FoldIn, bitwise
    the warm score (a cached plan would feed B's kernels A's tokens);
    ``zstats_zmap`` and ``zmap_logits`` against their plain versions at the
    inputs that B's warm score handed them."""
    from repro_torch.core.engine import InferenceResult
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ops, ref
    from repro_torch.query import FoldIn, FoldInConfig
    label = "slda_query"
    prog = m.compile()
    posts = {n: p.cpu().numpy() for n, p in state.posteriors.items()}
    post = InferenceResult("svi", posts, [], [], {}).freeze(m, program=prog)
    cfg = FoldInConfig(local_iters=10)
    warm = FoldIn(post, cfg, device="cuda")
    (va, sa, ba), (vb, sb, bb) = payloads
    pa = warm.plan(np.bincount(sa), bindings={"sents": ba})
    pb = warm.plan(np.bincount(sb), bindings={"sents": bb})
    log(f"[{label}] payloads A ({len(va)} tokens, {len(ba)} sentences) and "
        f"B ({len(vb)} tokens, {len(bb)} sentences), bucket {pb['caps']}")
    check(pa["signature"] == pb["signature"],
          f"{label}: payloads A and B land in different buckets")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ra = warm.score(va, segment_ids=sa, bindings={"sents": ba})
    with recording("zstats", "zmap_logits") as calls:
        rb = warm.score(vb, segment_ids=sb, bindings={"sents": bb})
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    cold = FoldIn(post, cfg, device="cuda").score(vb, segment_ids=sb,
                                                  bindings={"sents": bb})
    log(f"[{label}] per-token LL A {ra.per_token_ll:.6f}, B "
        f"{rb.per_token_ll:.6f} (both in {warm_s:.2f} s); launches {counts}")
    check(all(np.isfinite(r.doc_ll).all() and np.isfinite(r.per_token_ll)
              for r in (ra, rb)), f"{label}: a fold-in score is not finite")
    ok = (cold.elbo == rb.elbo and np.array_equal(cold.doc_ll, rb.doc_ll)
          and np.array_equal(cold.mixtures["theta"], rb.mixtures["theta"]))
    log(f"[{label}] B warm in A's bucket against B on a cold FoldIn: "
        f"{'bitwise' if ok else 'DIFFERENT'}")
    check(ok, f"{label}: a warm bucket scores B unlike a cold one")
    for name in ("zstats_zmap", "zmap_logits"):
        check(counts[name] > 0, f"{label}: {name} did not launch")

    log(f"[kernels vs plain] {label}: the inputs of B's warm score")
    args, plan = replayed(label, calls)
    (zkids, n_z, k), lkw, _ = [v for (n, _), v in calls.items()
                               if n == "zmap_logits"][0]
    err = compare_zstats(f"{label} request", fzm.zstats_zmap(
        *args, plan=plan), ref.zstats(*args), name="zstats_zmap")
    lerr = compare("zmap_logits", f"{label} request",
                   fzm.zmap_logits(zkids, n_z, k, **lkw),
                   ref.zmap_logits(zkids, n_z, k),
                   dict(rtol=ZSTATS_TOL["rtol"], atol=ZSTATS_TOL["atol"]))
    t_z = time_ms(lambda: fzm.zstats_zmap(*args, plan=plan), reps=20)
    t_zp = time_ms(lambda: ref.zstats(*args), reps=3)
    t_l = time_ms(lambda: fzm.zmap_logits(zkids, n_z, k, **lkw), reps=20)
    t_lp = time_ms(lambda: ref.zmap_logits(zkids, n_z, k), reps=3)
    del calls
    entries = []
    for name, t, tp, (bms, by), e in [
        ("zstats_zmap", t_z, t_zp, work_bound("zstats_zmap", *args), err),
        ("zmap_logits", t_l, t_lp, work_bound("zmap_logits", zkids, n_z, k),
         lerr),
    ]:
        rep = ("src/repro/kernels/fused_zmap.py:236" if name == "zstats_zmap"
               else "src/repro/kernels/fused_zmap.py:165")
        entries.append(kernel_entry(label, name, "cuda",
                                    "src/repro_torch/kernels/csrc/zstats.cu",
                                    rep, counts[name], e, t, tp, bms, by))
        log(f"  {name:<22} {t:9.4f} ms  plain {tp:9.4f} ms  bound "
            f"{bms:8.4f} ms ({by})  launches {counts[name]}")
    slda_gateway(label, post, cfg, payloads, (ra, rb))
    report[label] = dict(per_token_ll=[ra.per_token_ll, rb.per_token_ll],
                         launches=counts, warm_s=warm_s, caps=pb["caps"])
    return entries


def slda_gateway(label, post, cfg, payloads, scores):
    """Payloads A and B as PREDICT with bindings through a ``Gateway`` on
    the card: the direct route, each response bitwise the phase's own score
    of it (``scores``), EXPLAIN's route the executed one, and its kernel
    route zmap with the group logits, the route that the launches took."""
    from repro_torch.gateway import Gateway, TenantQuota
    from repro_torch.kernels import ops
    text = "PREDICT LL FOR DOCS $d USING ARTIFACT 'slda'"
    with Gateway(cfg, device="cuda") as gw:
        gw.register("slda", post, version="s0")
        # a payload with segment ids costs a token for each segment (here
        # a sentence, about 190 a payload), past the default burst of 200
        gw.set_quota("slda", TenantQuota(rate=1000.0, burst=1000.0))
        for name, (vals, sents, docs), want in zip("AB", payloads, scores):
            params = {"d": {"values": vals, "segment_ids": sents,
                            "bindings": {"sents": docs}}}
            ex = gw.query(f"EXPLAIN {text}", params=params, tenant="slda")
            ops.reset_launch_counts()
            r = gw.query(text, params=params, tenant="slda", timeout_s=120)
            torch.cuda.synchronize()
            routes = ops.route_counts()
            ok = (r.value["per_token_ll"] == want.per_token_ll
                  and np.array_equal(r.value["doc_ll"], want.doc_ll)
                  and np.array_equal(r.value["mixtures"]["theta"],
                                     want.mixtures["theta"]))
            log(f"[{label}] gateway PREDICT {name} with bindings "
                f"({r.route}): {'bitwise' if ok else 'DIFFERENT'} the "
                f"phase's score")
            check(ok, f"{label}: gateway PREDICT {name} is not the phase's "
                  f"score")
            check(ex.route == r.route and "[direct: nested-plate bindings]"
                  in r.route, f"{label}: EXPLAIN names {ex.route!r}, the "
                  f"execution {r.route!r}")
            named = explained_routes(ex.value["text"])
            check(named == {"z": EXPECTED_ROUTE["slda"]},
                  f"{label}: EXPLAIN names kernel routes {named}")
            route_check(label, f"EXPLAIN PREDICT {name}",
                        parse_route(named["z"]), routes)


def phase_gibbs(report, m, prog, corpus, svi_state, svi_heldout, n_holdout):
    """``make_engine("gibbs", steps=40, holdout_frac=0.05)`` on the main
    path's model (launch counts set to 0 just before and read just after,
    the kernels' inputs recorded in its held-out scoring), then
    ``gibbs_lda`` on the engine's training tokens twice: once with every
    sweep's counts checked against the training tokens, once timed alone
    for ms a sweep and peak memory; the three chains bitwise; the LL trace
    rising past burn-in, the held-out ELBO finite over the held-out
    documents of lda_svi; ``aligned_tv`` of phi beside the SVI fit's;
    ``zstats``, the Elog pass and ``zstep`` against their plain versions at
    the held-out scoring's own inputs (exact caps, the Gibbs posterior)."""
    from repro_torch.core import make_engine
    from repro_torch.core.gibbs import gibbs_lda
    from repro_torch.core.metrics import aligned_tv
    from repro_torch.kernels import ops
    label = "gibbs"
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording("zstats", "dirichlet_expectation", "zstep") as calls:
        res = make_engine("gibbs", steps=GIBBS_STEPS,
                          holdout_frac=GIBBS_HOLDOUT, seed=SEED,
                          device="cuda").fit(m)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    lls = np.asarray(res.elbo_trace, np.float64)
    burnin = res.meta["burnin"]
    log(f"[{label}] make_engine('gibbs', steps={GIBBS_STEPS}).fit "
        f"{fit_s:.2f} s, held-out scoring included; launches {counts}")

    # the engine's sampler call, on its own training split
    spec = prog.latents[0]
    child = spec.children[0]
    train = res.meta["train_groups"]
    member = np.zeros(prog.dirichlets[spec.prior_dir].g, bool)
    member[train] = True
    tm = member[spec.prior_rows]
    tokens = child.values[tm]
    docs = np.searchsorted(train, spec.prior_rows[tm])
    gkw = dict(alpha=float(prog.dirichlets[spec.prior_dir].prior[0]),
               beta=float(prog.dirichlets[child.dir_name].prior[0]),
               iters=GIBBS_STEPS, burnin=burnin, seed=SEED,
               return_conc=True, device="cuda")
    k, v = spec.k, prog.dirichlets[child.dir_name].k
    bad = []

    def on_sweep(it, cnt_d, cnt_k):
        nd, nk = int(cnt_d.sum()), int(cnt_k.sum())
        if not nd == nk == len(tokens):
            bad.append((it, nd, nk))
    checked = gibbs_lda(tokens, docs, k, v, on_sweep=on_sweep, **gkw)
    check(not bad, f"{label}: a sweep's counts do not sum to the training "
          f"tokens: {bad[:3]}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    alone = gibbs_lda(tokens, docs, k, v, **gkw)
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) / GIBBS_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    same_chain = all(np.array_equal(x, y) for x, y in
                     zip((*checked[:3], *checked[3]), (*alone[:3], *alone[3])))
    names = (spec.prior_dir, child.dir_name)
    engine = (np.array_equal(np.asarray(res.elbo_trace), alone[2])
              and all(np.array_equal(res.posteriors[n], alone[i])
                      and np.array_equal(res.meta["concentrations"][n],
                                         alone[3][i])
                      for i, n in enumerate(names)))
    log(f"[{label}] gibbs_lda over the {len(tokens)} training tokens: "
        f"counts checked each sweep, then alone {sweep_ms:.2f} ms a sweep "
        f"(set-up and the copy back included), "
        f"{len(tokens) / sweep_ms * 1e3:.4e} tokens/s, peak device memory "
        f"{peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held "
        f"before; the two runs {'bitwise' if same_chain else 'DIFFERENT'}, "
        f"the engine's chain {'bitwise' if engine else 'DIFFERENT'}")
    check(same_chain and engine, f"{label}: runs of one seed differ")
    del checked, alone
    early, late = lls[:burnin // 4].mean(), lls[burnin:].mean()
    log(f"[{label}] complete-data LL {lls[0]:.6e} -> {lls[-1]:.6e}; mean of "
        f"the first {burnin // 4} sweeps {early:.6e}, after burn-in "
        f"{late:.6e}")
    check(np.isfinite(lls).all() and late > early,
          f"{label}: the LL trace is not finite or did not rise")
    held = res.heldout_elbo
    log(f"[{label}] held-out per-token ELBO {held:.6f} over "
        f"{res.meta['n_holdout_groups']} documents (lda_svi: "
        f"{svi_heldout:.6f} over {n_holdout})")
    check(np.isfinite(held) and res.meta["n_holdout_groups"] == n_holdout,
          f"{label}: the held-out ELBO is not finite or not over lda_svi's "
          f"held-out documents")
    for name in ("zstats", "dirichlet_expectation", "zstep"):
        check(counts[name] > 0, f"{label}: {name} did not launch in the "
              f"held-out scoring")
    phi_svi = svi_state.posteriors["phi"].cpu().numpy().astype(np.float64)
    tv_g = aligned_tv(res.topics("phi"), corpus["true_phi"])
    tv_s = aligned_tv(phi_svi / phi_svi.sum(-1, keepdims=True),
                      corpus["true_phi"])
    log(f"[{label}] aligned_tv(phi, planted) {tv_g:.4f} (lda_svi's fit "
        f"{tv_s:.4f})")
    log(f"[kernels vs plain] {label}: the held-out scoring's own inputs "
        f"(exact caps, the Gibbs posterior)")
    entries = flat_recorded(label, calls, counts, "the held-out theta rows")
    report[label] = dict(
        fit_s=fit_s, sweep_ms=sweep_ms,
        tokens_per_s=len(tokens) / sweep_ms * 1e3, peak_bytes=peak,
        ll_trace=lls.tolist(), heldout=held, heldout_svi=svi_heldout,
        aligned_tv=tv_g, aligned_tv_svi=tv_s, launches=counts)
    return entries


# ---------------------------------------------------------------------------
# the distributed path: co-partitioned VMP over 2 shards, sharded and
# multi-host SVI (virtual hosts, and 2 processes over gloo on the one card)
# ---------------------------------------------------------------------------

# the reference's bounds: a plan's trace and posteriors within 1e-4 of one
# device's (scripts/dist_checks.py), 2 virtual hosts within 5e-4 of the
# plain plan (tests/test_multihost.py); the held-out score of a hosts run is
# summed per shard, so it meets the plain plan's (one scorer) within 1e-5
DIST_SHARDS, DIST_VMP_STEPS, DIST_SVI_STEPS, DIST_TIMED_STEPS = 2, 5, 10, 5
DIST_REL, DIST_HOSTS_TOL, DIST_HELD_RTOL = 1e-4, 5e-4, 1e-5
# disk shards of 2^20 tokens (about 10 over the main path's corpus, so that
# both hosts own some); sessions every 2 steps, the crash entering step 5
# (the 6th trip of "svi.step")
DIST_SHARD_TOKENS, DIST_EVERY, DIST_CRASH_AT = 1 << 20, 2, 6

# one host of the 2-process run: rank {rank} of a gloo group on the card,
# through the entry point a user calls; it loads the kernel library the
# parent built
DIST_CHILD = """
import sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.core import models
from repro_torch.launch.elastic import multihost_svi_session
res = multihost_svi_session(
    models.make("lda", alpha={alpha!r}, beta={beta!r}, K={k!r}, V={v!r}),
    {engine!r}, {path!r}, None, n_hosts=2, host_id={rank},
    coordinator="127.0.0.1:{port}")
g = res.meta["group"]
print("TIMES", res.meta["fit_s"], g["seconds"], g["calls"],
      sum(g["wire"].values()), g["wire"].get("phi", 0),
      g["wire"].get("theta", 0), flush=True)
if {rank} == 0:
    np.savez({out!r}, elbo=np.asarray(res.elbo_trace, np.float64),
             heldout=np.asarray([v for _, v in res.heldout_trace],
                                np.float64), **res.posteriors)
print("DONE", flush=True)
"""


# the crash child: 2 virtual hosts with sessions, armed through
# REPRO_FAULTS to SIGKILL itself entering a step
DIST_KILL_CHILD = """
import sys
sys.path.insert(0, {src!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.core import models
from repro_torch.launch.elastic import multihost_svi_session
multihost_svi_session(
    models.make("lda", alpha={alpha!r}, beta={beta!r}, K={k!r}, V={v!r}),
    {engine!r}, {path!r}, {ck!r}, n_hosts=2)
"""


def rel_max(got, want):
    """max |got - want| / max |want|: the reference's measure of two
    posteriors (scripts/dist_checks.py)."""
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def dist_vmp(label, out, prog):
    """Full-batch VMP under ``ShardingPlan(2, "inferspark")`` from the main
    path's initial state: DIST_VMP_STEPS steps within DIST_REL of as many
    one-device steps in this process (the ELBO trace elementwise, the
    gathered phi and theta), two runs bitwise, each step handing the shard
    group every shard's phi stats and ELBO and nothing of theta, with no
    byte over the wire in one process (the 2-process SVI run measures
    phi's exchange against ``collective_bytes_per_iteration``), ms a step
    and the owner plans' host ms per shard, one step under the profiler;
    ``zstats`` (masked, one shard's block) and the Elog pass at the inputs
    one shard handed them, recorded as they ran."""
    from repro_torch.core import partition, runtime, vmp
    from repro_torch.kernels import ops
    s0 = vmp.init_state(prog, SEED, device="cuda")
    one = runtime.make_step(prog, device="cuda")
    st, trace1 = s0, []
    for _ in range(DIST_VMP_STEPS):
        st, e = one(st)
        trace1.append(float(e))
    single = {n: p.cpu().numpy() for n, p in st.posteriors.items()}
    del st, one
    plan = partition.ShardingPlan(DIST_SHARDS, "inferspark")
    t0 = time.perf_counter()
    step, sd0 = partition.make_distributed_step(prog, plan, device="cuda",
                                                state=s0)
    build_s = time.perf_counter() - t0
    layout = step.layout
    want = partition.collective_bytes_per_iteration(prog, plan)
    # every shard hands its f32 stats of each global Dirichlet and its ELBO
    handed = {"elbo": DIST_SHARDS * 4, **{
        n: DIST_SHARDS * d.g * d.k * 4 for n, d in prog.dirichlets.items()
        if d.group_rows is None}}
    log(f"[{label}] ShardingPlan({DIST_SHARDS}, 'inferspark'): layout and "
        f"owner plans {build_s:.2f} s (owner plans "
        f"{', '.join(f'{ms:.1f}' for ms in step.plan_ms.values())} ms a "
        f"shard); caps {dict((n, i['cap']) for n, i in layout.lat.items())} "
        f"tokens, theta {layout.dir_row['theta']['cap']} rows a shard; "
        f"collective_bytes_per_iteration {want}")
    runs = []
    for run in range(2):
        st, trace, moved = sd0, [], []
        with recording("zstats", "dirichlet_expectation") as calls:
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DIST_VMP_STEPS):
                before = dict(plan.group.payload)
                st, e = step(st)
                trace.append(float(e))
                moved.append({k: v - before.get(k, 0)
                              for k, v in plan.group.payload.items()})
            step_ms = (time.perf_counter() - t0) / DIST_VMP_STEPS * 1e3
            counts = ops.launch_counts()
        runs.append(dict(state=st, trace=trace, moved=moved, step_ms=step_ms,
                         calls=calls, counts=counts))
    a, b = runs
    bitwise_ok = a["trace"] == b["trace"] and all(
        torch.equal(a["state"].posteriors[n], b["state"].posteriors[n])
        for n in prog.dirichlets)
    t_rel = max(abs(x - y) / abs(y) for x, y in zip(a["trace"], trace1))
    p_rel = {n: rel_max(partition.gather_posterior(step, prog, a["state"], n),
                        single[n]) for n in ("theta", "phi")}
    counts = a["counts"]
    log(f"[{label}] {DIST_VMP_STEPS} steps: ELBO {a['trace'][0]:.6e} -> "
        f"{a['trace'][-1]:.6e}; against one device: trace max rel "
        f"{t_rel:.2e}, theta {p_rel['theta']:.2e}, phi {p_rel['phi']:.2e} "
        f"(tol {DIST_REL}); two runs "
        f"{'bitwise' if bitwise_ok else 'DIFFERENT'}; handed to the group "
        f"a step {a['moved'][0]} bytes (want {handed}), over the wire "
        f"{plan.group.wire_bytes}; "
        f"{a['step_ms']:.2f} / {b['step_ms']:.2f} ms a step; launches "
        f"{counts}")
    check(t_rel <= DIST_REL and max(p_rel.values()) <= DIST_REL,
          f"{label}: the co-partitioned run is not within {DIST_REL} of one "
          f"device")
    check(bitwise_ok, f"{label}: two runs from one state differ")
    check(a["moved"] == [handed] * DIST_VMP_STEPS
          and plan.group.wire_bytes == 0,
          f"{label}: the shards did not hand the group phi's stats and the "
          f"ELBO alone, or bytes went over the wire in one process")
    check(counts["zstats"] == DIST_SHARDS * DIST_VMP_STEPS,
          f"{label}: zstats launched {counts['zstats']} times")
    st = b["state"]

    def run():
        nonlocal st
        st, e = step(st)
        float(e)
    trace = profile_steps(run, 1, label=f"{label} trace")
    args, zplan = replayed(label, a["calls"])
    theta = a["calls"]["dirichlet_expectation", tuple(args[0].shape)][0][0]
    entries = flat_kernel_entries(label, args, zplan, theta, counts,
                                  "one shard's theta rows")
    out["vmp"] = dict(trace=a["trace"], single_trace=trace1,
                      trace_rel=t_rel, posterior_rel=p_rel,
                      payload_per_step=a["moved"], want_payload=handed,
                      collective_bytes_per_iteration=want,
                      step_ms=[a["step_ms"], b["step_ms"]],
                      plan_ms=step.plan_ms, build_s=build_s, launches=counts,
                      profile=trace)
    return entries


def dist_svi(label, out, corpus, tmp):
    """SVI at lda_svi's settings under a 2-shard plan, over the main path's
    corpus in disk shards of DIST_SHARD_TOKENS tokens, DIST_SVI_STEPS steps
    each: the plain plan path; ``hosts=HostAssignment(1, 0)`` bitwise it;
    2 virtual hosts within DIST_HOSTS_TOL of it; two child processes on the
    card over gloo, each opening the corpus through its own host view,
    bitwise the 2-virtual-host run (posteriors, ELBO and held-out traces),
    each rank's phi bytes over the wire ``collective_bytes_per_iteration``
    a step; that run with sessions in a child SIGKILLed entering step
    DIST_CRASH_AT - 1, resumed here, bitwise it.  Per step the host clock,
    the group's ms and the bytes handed to it, the owned disk bytes of each host, one step
    under the profiler; ``zstats`` and the Elog pass at one shard's inputs
    of a further step, recorded as they ran."""
    import os
    import socket
    from repro_torch.checkpoint import latest_session_step
    from repro_torch.core import models
    from repro_torch.core.partition import (ShardingPlan,
                                            collective_bytes_per_iteration)
    from repro_torch.core.svi import SVI
    from repro_torch.data import (HostAssignment, ShardedCorpus,
                                  sharded_template, write_sharded_corpus)
    from repro_torch.kernels import ops
    from repro_torch.testing import faults
    path = str(tmp / "corpus")
    t0 = time.perf_counter()
    sc = write_sharded_corpus(corpus, path, shard_tokens=DIST_SHARD_TOKENS)
    views = [ShardedCorpus.open(path, hosts=HostAssignment(2, h))
             for h in (0, 1)]
    owned = [int(v.owned_disk_bytes) for v in views]
    log(f"[{label}] {sc.n_tokens} tokens in {sc.n_shards} shards "
        f"({sc.disk_bytes} bytes) written in {time.perf_counter() - t0:.2f} "
        f"s; 2 hosts own shards {[v.owned_shards().tolist() for v in views]}"
        f", {owned} bytes on disk")
    check(all(len(v.owned_shards()) for v in views),
          f"{label}: a host owns no shard")
    tmpl = sharded_template(models.make("lda", alpha=ALPHA, beta=BETA,
                                        K=TOPICS, V=VOCAB), sc)
    want_phi = collective_bytes_per_iteration(
        tmpl, ShardingPlan(DIST_SHARDS))["phi"]
    cfg = svi_config()

    def make(hosts):
        return SVI(tmpl, cfg, plan=ShardingPlan(DIST_SHARDS, "inferspark"),
                   corpus=ShardedCorpus.open(path), hosts=hosts,
                   device="cuda")

    def posts(state):
        return {n: p.cpu().numpy() for n, p in state.posteriors.items()}

    fits = {}
    for name, hosts in (("plan", None), ("hosts1", HostAssignment(1, 0)),
                        ("hosts2", HostAssignment(2, 0))):
        svi = make(hosts)
        group = svi.plan.group
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = svi.fit(DIST_SVI_STEPS)
        fits[name] = dict(svi=svi, state=state, hist=hist,
                          fit_s=time.perf_counter() - t0,
                          counts=ops.launch_counts(), group_s=group.seconds,
                          group_payload=group.payload_bytes)
        if name != "hosts2":
            svi.close()
    plain, one, two = fits["plan"], fits["hosts1"], fits["hosts2"]
    held = {k: [v for _, v in f["hist"]["heldout"]] for k, f in fits.items()}
    ok1 = one["hist"]["elbo"] == plain["hist"]["elbo"] and all(
        torch.equal(one["state"].posteriors[n], plain["state"].posteriors[n])
        for n in plain["state"].posteriors)
    h_rel = max(abs(x - y) / abs(y) for x, y in zip(held["hosts1"],
                                                     held["plan"]))
    p2 = {n: float(np.max(np.abs(a - b) / (DIST_HOSTS_TOL + DIST_HOSTS_TOL
                                            * np.abs(b))))
          for (n, a), b in zip(posts(two["state"]).items(),
                               posts(plain["state"]).values())}
    log(f"[{label}] {DIST_SVI_STEPS} steps each: hosts=HostAssignment(1, 0) "
        f"{'bitwise' if ok1 else 'DIFFERENT FROM'} the plain plan path "
        f"(posteriors, batch ELBO), held-out within {h_rel:.2e} (tol "
        f"{DIST_HELD_RTOL}); 2 virtual hosts against it: max |diff| / (atol "
        f"+ rtol |want|) {p2} (<= 1 at rtol = atol = {DIST_HOSTS_TOL}); "
        f"held-out {held}")
    check(ok1 and h_rel <= DIST_HELD_RTOL, f"{label}: hosts=(1, 0) is not "
          f"the plain plan path")
    check(max(p2.values()) <= 1.0, f"{label}: 2 virtual hosts are not "
          f"within {DIST_HOSTS_TOL} of the plain plan path")
    counts, evals = two["counts"], len(two["hist"]["heldout"])
    want_z = DIST_SHARDS * (DIST_SVI_STEPS + evals
                            * (cfg.holdout_local_iters + 1))
    check(np.isfinite(two["hist"]["elbo"]).all() and evals
          and np.isfinite(held["hosts2"]).all(),
          f"{label}: a 2-virtual-host ELBO is not finite")
    check(counts["zstats"] == want_z, f"{label}: zstats launched "
          f"{counts['zstats']} times, not {want_z}")

    # two processes on the card, each one host over gloo
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    npz = str(tmp / "two_proc.npz")
    engine = dict(backend="svi", steps=DIST_SVI_STEPS, device="cuda",
                  **ooc_config())
    env = {k: v for k, v in os.environ.items() if k != faults.ENV_VAR}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_CHILD.format(
            src=str(ROOT / "src"), alpha=ALPHA, beta=BETA, k=TOPICS,
            v=VOCAB, engine=engine, path=path, rank=rank, port=port,
            out=npz)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    results = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=CHILD_TIMEOUT)
            results.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (code, o, e) in enumerate(results):
        if code != 0 or "DONE" not in o:
            log(f"[{label}] rank {rank} exit {code}:\n{e[-4000:]}")
    check(all(code == 0 and "DONE" in o for code, o, _ in results),
          f"{label}: a process of the 2-process run failed")
    times = [[float(x) for x in line.split()[1:]] for _, o, _ in results
             for line in o.splitlines() if line.startswith("TIMES ")]
    got = np.load(npz)
    want2 = dict(posts(two["state"]), elbo=np.asarray(two["hist"]["elbo"]),
                 heldout=np.asarray(held["hosts2"]))
    ok2 = set(got.files) == set(want2) and all(
        np.array_equal(got[k], want2[k]) for k in want2)
    log(f"[{label}] 2 processes over gloo on {torch.cuda.get_device_name(0)}"
        f" (cuda:0 each), {wall:.1f} s with start-up: "
        f"{'bitwise' if ok2 else 'DIFFERENT FROM'} the 2-virtual-host run "
        f"(posteriors, ELBO and held-out traces); per rank fit "
        f"{[round(t[0], 3) for t in times]} s, group "
        f"{[round(t[1], 3) for t in times]} s in "
        f"{[int(t[2]) for t in times]} exchanges, over the wire (sent and "
        f"received) {[int(t[3]) for t in times]} bytes, phi's "
        f"{[int(t[4]) for t in times]} (want {DIST_SVI_STEPS} x "
        f"{want_phi}: collective_bytes_per_iteration), theta's "
        f"{[int(t[5]) for t in times]}")
    check(ok2, f"{label}: 2 processes are not bitwise 2 virtual hosts")
    check(len(times) == 2 and all(int(t[4]) == DIST_SVI_STEPS * want_phi
                                  for t in times),
          f"{label}: phi's bytes over the wire are not "
          f"collective_bytes_per_iteration a step")

    # a 2-virtual-host session SIGKILLed in a child and resumed here
    ck = str(tmp / "ck")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", DIST_KILL_CHILD.format(
            src=str(ROOT / "src"), alpha=ALPHA, beta=BETA, k=TOPICS, v=VOCAB,
            engine=dict(engine, checkpoint_every=DIST_EVERY), path=path,
            ck=ck)],
        env=dict(env, **{faults.ENV_VAR: f"svi.step=kill@{DIST_CRASH_AT}"}),
        capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    at = latest_session_step(ck)
    if res.returncode != -9:
        log(res.stderr[-4000:])
    check(res.returncode == -9 and at in (DIST_CRASH_AT - 4,
                                          DIST_CRASH_AT - 2),
          f"{label}: the child did not die by SIGKILL entering step "
          f"{DIST_CRASH_AT - 1} with a session")
    again = make(HostAssignment(2, 0))
    got_s, got_h = again.fit(DIST_SVI_STEPS - at, checkpoint_dir=ck,
                             resume_from=True)
    again.close()
    ok3 = states_bitwise(got_s, two["state"], got_h, two["hist"])
    log(f"[{label}] 2 virtual hosts in a child, svi.step=kill@"
        f"{DIST_CRASH_AT}: exit {res.returncode} after "
        f"{time.perf_counter() - t0:.1f} s, newest valid session at step "
        f"{at}; resumed here: {'bitwise' if ok3 else 'DIFFERENT FROM'} the "
        f"straight run")
    check(ok3, f"{label}: crash-resume of 2 virtual hosts is not bitwise")

    # per step, after the fit: host clock, the group's ms and bytes
    svi, st = two["svi"], two["state"]
    group = svi.plan.group
    g0 = (group.seconds, group.payload_bytes)
    steps = range(DIST_SVI_STEPS, DIST_SVI_STEPS + DIST_TIMED_STEPS)
    tokens = float(np.mean([svi._weights[svi.sampler.batch_at(t)].sum()
                            for t in steps]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in steps:
        st, e = svi.step(t, st)
        float(e)
    step_ms = (time.perf_counter() - t0) / len(steps) * 1e3
    group_ms = (group.seconds - g0[0]) / len(steps) * 1e3
    group_bytes = (group.payload_bytes - g0[1]) / len(steps)
    t_next = DIST_SVI_STEPS + DIST_TIMED_STEPS

    def run():
        nonlocal st
        st, e = svi.step(t_next, st)
        float(e)
    trace = profile_steps(run, 1, label=f"{label} trace")
    with recording("zstats", "dirichlet_expectation") as calls:
        st, e = svi.step(t_next + 1, st)
        float(e)
    svi.close()
    idle = (1 - trace["busy_ms"] / trace["step_ms"]
            if trace["busy_ms"] > 0 else None)
    log(f"[{label} times] per step over {len(steps)} steps of {tokens:.0f} "
        f"tokens, 2 virtual hosts: {step_ms:.2f} ms host clock, "
        f"{tokens / step_ms * 1e3:.4e} tokens/s; the group {group_ms:.3f} ms "
        f"and {group_bytes:.0f} bytes handed to it a step (none over the "
        f"wire: {group.wire_bytes}); the plain plan's fit "
        f"{plain['fit_s'] / DIST_SVI_STEPS * 1e3:.2f} ms a step, 2 virtual "
        f"hosts' {two['fit_s'] / DIST_SVI_STEPS * 1e3:.2f} (one held-out "
        f"evaluation in each); device {trace['busy_ms']:.3f} ms of a "
        f"{trace['step_ms']:.2f} ms step, idle share "
        f"{'not measured' if idle is None else f'{idle:.3f}'}")
    args, zplan = replayed(label, calls)
    theta = calls["dirichlet_expectation", tuple(args[0].shape)][0][0]
    entries = flat_kernel_entries(label, args, zplan, theta, counts,
                                  "one shard's batch theta rows")
    out["svi"] = dict(
        n_shards=sc.n_shards, owned_shards=[v.owned_shards().tolist()
                                            for v in views],
        owned_disk_bytes=owned, hosts1_bitwise=ok1, heldout_rel=h_rel,
        hosts2_vs_plan=p2, two_process_bitwise=ok2, two_process_s=wall,
        two_process_times=times, crash_session_step=at, step_ms=step_ms,
        tokens_per_step=tokens, group_ms=group_ms,
        group_payload_bytes=group_bytes, wire_phi_bytes=want_phi,
        fit_s={k: f["fit_s"] for k, f in fits.items()}, profile=trace,
        idle_share=idle, heldout=held, launches=counts)
    return entries


def phase_lda_dist(report, corpus, prog):
    """The distributed path at the main path's widths: co-partitioned
    full-batch VMP (:func:`dist_vmp`, entry ``lda_dist``), then sharded and
    multi-host SVI (:func:`dist_svi`, entry ``lda_multihost``)."""
    import tempfile
    out = report["lda_dist"] = {}
    entries = dist_vmp("lda_dist", out, prog)
    with tempfile.TemporaryDirectory(prefix="lda_dist-") as tmpdir:
        entries += dist_svi("lda_multihost", out, corpus, Path(tmpdir))
    return entries


# ---------------------------------------------------------------------------
# the LM trainer: olmo-1b at full width and depth, attention through the
# flash_attention kernel
# ---------------------------------------------------------------------------

def flash_inputs(bh, sq, sk, dh, dtype, seed):
    """q (bh, sq, dh) and k, v (bh, sk, dh) from a numpy seed, on the card."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(bh, n, dh)).astype(
        np.float32)).to(DEV, dtype) for n in (sq, sk, sk))


def flash_bound(q, k, v):
    """(causal flash attention's FLOPs at q, k, v, its ``work_bound``)."""
    from repro_torch.kernels import work
    return (work.flash_attention(q, k, v, True)[0],
            work_bound("flash_attention", q, k, v, True))


def phase_flash(report):
    """``flash_attention`` against ``ref.flash_attention`` on the card: the
    reference's FLASH_SHAPES, Sq != Sk, a non-causal ragged Sk, Dh = 80 and
    256, ragged and multi-tile cases at Dh 64 and 128, FLASH_DH256_TIMED and
    the trainer's shape, in bf16 and f32, each through the route ``route()``
    gives it (and checked to have taken it), and the bf16 cases at Dh 64,
    128 and 256 also through the "mma" route; two launches of each route
    bitwise; the Function's gradients bitwise those of the plain version
    for one g; both routes timed in turns at the trainer's shape beside the
    bound, the plain version and SDPA (a yardstick the port never calls),
    and at FLASH_DH256_TIMED (:func:`flash_dh256_times`)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    log("[flash] flash_attention against ref.flash_attention")
    bh, s, dh = LM_BH, LM_SEQ, 128
    cases = [(b, n, n, d, True) for b, n, d in FLASH_SHAPES] + [
        (2, 48, 100, 32, True), (2, 100, 48, 16, True), (3, 70, 100, 32, False),
        (2, 130, 130, 80, True), (2, 64, 96, 80, False), (2, 300, 300, 256, True),
        (2, 100, 77, 256, False)] + FLASH_WGMMA_CASES + [
        (b, n, n, 256, True) for b, n in FLASH_DH256_TIMED] + [
        (bh, s, s, dh, True)]
    worst = {}
    for i, (b, sq, sk, d, causal) in enumerate(cases):
        for dt, tol in ((torch.bfloat16, FLASH_BF16_TOL),
                        (torch.float32, FLASH_F32_TOL)):
            q, k, v = flash_inputs(b, sq, sk, d, dt, 500 + i)
            want = ref.flash_attention(q, k, v, causal=causal)
            rt = fa.route(q, k, v)
            label = (f"({b},{sq},{sk},{d}) {'causal' if causal else 'full'} "
                     f"{str(dt)[6:]}")
            before = ops.route_counts()["flash_attention"]
            got = fa.flash_attention(q, k, v, causal=causal)
            after = ops.route_counts()["flash_attention"]
            check(after[rt] == before[rt] + 1 and
                  sum(after.values()) == sum(before.values()) + 1,
                  f"flash_attention {label} did not take route {rt}")
            worst[label] = compare("flash_attention", f"{label} {rt}", got,
                                   want, tol)
            if rt == "wgmma":
                worst[label + " mma"] = compare(
                    "flash_attention", f"{label} mma",
                    fa.launch(q, k, v, causal, route="mma"), want, tol)
            del q, k, v, want, got
    q, k, v = flash_inputs(bh, s, s, dh, torch.bfloat16, 600)
    check(fa.route(q, k, v) == "wgmma", "the trainer's shape is not on the "
          "wgmma route")
    for rt in ("wgmma", "mma"):
        a = fa.launch(q, k, v, True, route=rt)
        check(torch.equal(a, fa.launch(q, k, v, True, route=rt)),
              f"two flash_attention launches ({rt}) on one input differ")
    log("  two launches of each route at the trainer's shape: bitwise equal")
    for b, n, dt in ((bh, s, torch.bfloat16), (4, 256, torch.float32)):
        qg, kg, vg = (t.requires_grad_() for t in flash_inputs(
            b, n, n, dh, dt, 601))
        g = torch.from_numpy(np.random.default_rng(602).normal(
            size=(b, n, dh)).astype(np.float32)).to(DEV, dt)
        got = torch.autograd.grad(fa.flash_attention(qg, kg, vg), (qg, kg, vg), g)
        want = torch.autograd.grad(ref.flash_attention(qg, kg, vg),
                                   (qg, kg, vg), g)
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"Function gradients at ({b},{n},{dh}) {dt} differ from ref's")
        log(f"  Function gradients at ({b},{n},{n},{dh}) {str(dt)[6:]}: "
            f"bitwise those of ref.flash_attention for one g")
        del qg, kg, vg, g, got, want
    torch.cuda.synchronize()

    log("[times] flash_attention at the trainer's shape "
        f"({bh}, {s}, {dh}) bf16, causal; the two routes in turns")
    turns = {"mma": [], "wgmma": []}
    for rt in ("mma", "wgmma", "wgmma", "mma"):
        turns[rt].append(time_ms(lambda: fa.launch(q, k, v, True, route=rt),
                                 reps=20))
    t_k, t_m = (sum(turns[r]) / 2 for r in ("wgmma", "mma"))
    t_p = time_ms(lambda: ref.flash_attention(q, k, v), reps=5)
    q4, k4, v4 = (t.view(LM_BATCH, bh // LM_BATCH, s, dh) for t in (q, k, v))
    t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), reps=20)
    flops, (bms, by) = flash_bound(q, k, v)
    for name, t in (("wgmma", t_k), ("mma", t_m), ("SDPA", t_l)):
        log(f"  {name:<6} {t:9.4f} ms  {flops / t / 1e9:8.1f} TFLOP/s  "
            f"{bms / t:.3f} of the bound")
    log(f"  turns (ms): mma {turns['mma']}, wgmma {turns['wgmma']}")
    log(f"  plain {t_p:9.4f} ms  bound {bms:8.4f} ms ({by})")
    check(t_k < t_m, f"the wgmma kernel ({t_k:.4f} ms) is not faster than "
          f"the mma kernel ({t_m:.4f} ms)")
    err = worst[f"({bh},{s},{s},{dh}) causal bfloat16"]
    out = dict(ms=t_k, mma_ms=t_m, turns=turns, plain_ms=t_p, library_ms=t_l,
               bound_ms=bms, bound_by=by, err=err, mma_err=worst[
                   f"({bh},{s},{s},{dh}) causal bfloat16 mma"])
    del q, k, v, q4, k4, v4
    report["flash"] = dict(out, cases=worst, dh256=flash_dh256_times(worst))
    return out


def flash_dh256_times(worst):
    """At each of FLASH_DH256_TIMED (Dh 256, bf16, causal): two launches of
    each route bitwise, both routes timed in turns beside SDPA (a yardstick
    the port never calls), the plain version and the bound, and the wgmma
    route checked to beat the mma route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    out = {}
    for bh, s in FLASH_DH256_TIMED:
        q, k, v = flash_inputs(bh, s, s, 256, torch.bfloat16, 603)
        check(fa.route(q, k, v) == "wgmma", f"({bh}, {s}, 256) bf16 is not "
              f"on the wgmma route")
        for rt in ("wgmma", "mma"):
            a = fa.launch(q, k, v, True, route=rt)
            check(torch.equal(a, fa.launch(q, k, v, True, route=rt)),
                  f"two flash_attention launches ({rt}) at ({bh}, {s}, 256) "
                  f"differ")
        del a
        q4, k4, v4 = (t.view(1, bh, s, 256) for t in (q, k, v))
        runs = {"wgmma": lambda: fa.launch(q, k, v, True, route="wgmma"),
                "mma": lambda: fa.launch(q, k, v, True, route="mma"),
                "SDPA": lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True)}
        turns = {r: [] for r in runs}
        for r in ("mma", "wgmma", "SDPA", "SDPA", "wgmma", "mma"):
            turns[r].append(time_ms(runs[r], reps=20))
        t = {r: sum(x) / 2 for r, x in turns.items()}
        t_p = time_ms(lambda: ref.flash_attention(q, k, v), reps=3)
        flops, (bms, by) = flash_bound(q, k, v)
        log(f"[times] flash_attention at ({bh}, {s}, 256) bf16, causal; "
            f"two launches of each route bitwise; the routes in turns")
        for r in runs:
            log(f"  {r:<6} {t[r]:9.4f} ms  {flops / t[r] / 1e9:8.1f} TFLOP/s"
                f"  {bms / t[r]:.3f} of the bound")
        log(f"  turns (ms): {turns}")
        log(f"  plain {t_p:9.4f} ms  bound {bms:8.4f} ms ({by})")
        check(t["wgmma"] < t["mma"], f"at ({bh}, {s}, 256) the wgmma kernel "
              f"({t['wgmma']:.4f} ms) is not faster than the mma kernel "
              f"({t['mma']:.4f} ms)")
        label = f"({bh},{s},{s},256) causal bfloat16"
        out[f"({bh}, {s}, 256)"] = dict(
            ms=t["wgmma"], mma_ms=t["mma"], library_ms=t["SDPA"], turns=turns,
            plain_ms=t_p, bound_ms=bms, bound_by=by, err=worst[label],
            mma_err=worst[label + " mma"])
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    return out


def leaf_sums(module):
    """Per parameter, the f64 sum and sum of squares: a change of any
    element moves them."""
    return [(float(p.detach().double().sum()),
             float(p.detach().double().square().sum()))
            for p in module.parameters()]


def chance_level(params, cfg, run, batch):
    """The model's expected CE on ``batch``'s positions under labels drawn
    uniformly from the vocabulary: the mean of ``logsumexp(z) - mean(z)``
    over the V real columns of its logits.  TokenStream's labels are
    uniform, so the loss of parameters that have not seen them lies within
    noise of this (0.01 nats at 8,192 tokens); a label that leaks from the
    input scores far below it."""
    from repro_torch.models import transformer as T
    with torch.no_grad():
        x = T._embed(params, batch["tokens"], cfg, run)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        z = T._logits(params, T._apply_stack(params, x, cfg, run, pos), cfg,
                      run)[..., :cfg.vocab]
        return float((torch.logsumexp(z, -1) - z.mean(-1)).mean())


def phase_lm_train(report, flash):
    """olmo-1b at full width and depth through ``launch.train.train``: 4
    steps at batch 4 x 2,048 tokens, bf16 compute, f32 parameters from the
    port's own initialisation, attention through the flash kernel; the
    launch count, the losses, the parameters' movement, flash against dense
    attention on one batch, step time, tokens/s, the model flops' share of
    the bf16 peak, peak memory, and a profile of two steps."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import PEAK_FLOPS
    from repro_torch.launch.steps import batch_to, build_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import make_model
    cfg = get_arch(LM_ARCH)
    run = RunConfig(seq_len=LM_SEQ, global_batch=LM_BATCH, flash_kernel=True)
    n_params = cfg.param_count()
    log(f"[lm_train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab} (padded {cfg.vocab_padded}), {n_params / 1e9:.3f}B "
        f"parameters; batch {LM_BATCH} x {LM_SEQ}, {run.dtype} compute")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, losses, tel = train(cfg, run, LM_STEPS, device=DEV,
                                     log_every=1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lm_train] train(steps={LM_STEPS}) {train_s:.2f} s (init included); "
        f"losses {losses}")
    log(f"[lm_train] launches: {counts}")
    want = cfg.n_layers * LM_STEPS
    routes = ops.route_counts()["flash_attention"]
    log(f"[lm_train] flash_attention launches by route: {routes}")
    check(counts["flash_attention"] == want,
          f"flash_attention launched {counts['flash_attention']} times, not "
          f"{want} ({cfg.n_layers} layers x {LM_STEPS} forwards)")
    check(routes == {"wgmma": want, "mma": 0},
          f"flash_attention's {want} launches did not all take the wgmma "
          f"route: {routes}")
    check(opt["count"] == LM_STEPS, f"AdamW count {opt['count']}")
    stream = TokenStream(vocab=cfg.vocab, seq_len=LM_SEQ, batch=LM_BATCH,
                         seed=run.seed)
    batch = batch_to(stream.batch_at(0), DEV)
    # the initialisation again (one generator seed gives the same draws)
    fresh = make_model(cfg)["init"](run, device=DEV)
    moved = [a != b for a, b in zip(leaf_sums(params), leaf_sums(fresh))]
    chance = chance_level(fresh, cfg, run, batch)
    del fresh
    check(all(moved), f"{moved.count(False)} of {len(moved)} parameters "
                      f"unchanged after {LM_STEPS} steps")
    log(f"[lm_train] all {len(moved)} parameters moved from the "
        f"initialisation (the schedule gives lr 0 at step 0, so steps 1-3 "
        f"moved them)")
    ln_v = float(np.log(cfg.vocab))
    log(f"[lm_train] chance level of the initial logits on batch 0: "
        f"{chance:.4f} nats (ln V = {ln_v:.4f}: the tied embedding gives each "
        f"input token a large logit of its own); step 0's loss lies "
        f"{abs(losses[0] - chance):.2e} from it (tol {CHANCE_TOL})")
    check(abs(losses[0] - chance) <= CHANCE_TOL,
          f"step 0's loss {losses[0]} is not the chance level {chance} of "
          f"its logits")
    check(all(np.isfinite(losses)) and
          all(abs(x - chance) <= 1.5 for x in losses),
          f"losses {losses} not finite within 1.5 nats of the chance level "
          f"{chance:.4f}")
    log("[lm_train] every loss finite and within 1.5 nats of the chance level")

    model = make_model(cfg)
    with torch.no_grad():
        l_flash = float(model["train_loss"](params, batch, run))
        l_dense = float(model["train_loss"](
            params, batch, dataclasses.replace(run, flash_kernel=False)))
    log(f"[lm_train] batch 0 after training: loss {l_flash:.6f} through the "
        f"flash kernel, {l_dense:.6f} through _sdpa_dense (|diff| "
        f"{abs(l_flash - l_dense):.2e}, tol {LM_LOSS_TOL} nats)")
    check(abs(l_flash - l_dense) <= LM_LOSS_TOL,
          "flash and dense attention give losses more than "
          f"{LM_LOSS_TOL} nats apart")

    summ = tel.summary()
    step_s = summ["mean_s"]
    tokens = LM_BATCH * LM_SEQ
    attn_flops = 3 * cfg.n_layers * flash_bound(*[torch.empty(
        (LM_BH, LM_SEQ, cfg.head_dim_), dtype=torch.bfloat16,
        device="meta")] * 3)[0]
    model_flops = 6 * n_params * tokens + attn_flops
    mfu = model_flops / step_s / PEAK_FLOPS
    log(f"[lm_train] step {step_s * 1e3:.2f} ms (mean of steps 1-"
        f"{LM_STEPS - 1}), {tokens / step_s:.4e} tokens/s; 6*N*tokens + "
        f"attention = {model_flops:.4e} flops, {mfu:.4f} of the bf16 peak; "
        f"peak memory {peak_gb:.2f} GB")
    built = build_train_step(cfg, run, device=DEV)
    nxt = [LM_STEPS]

    def two_steps():
        nonlocal params, opt
        for _ in range(2):
            b = batch_to(stream.batch_at(nxt[0]), DEV)
            params, opt, m = built["fn"](params, opt, b, nxt[0])
            float(m["loss"])
            nxt[0] += 1
    trace = profile_steps(two_steps, 2, label="lm_train trace")
    report["lm_train"] = dict(
        arch=cfg.name, seq=LM_SEQ, batch=LM_BATCH, steps=LM_STEPS,
        losses=losses, launches=counts, train_s=train_s, step_ms=step_s * 1e3,
        step_times_s=tel.times, tokens_per_s=tokens / step_s,
        model_flops=model_flops, bf16_peak_share=mfu, peak_memory_gb=peak_gb,
        loss_flash=l_flash, loss_dense=l_dense, chance_level=chance,
        trace=trace)
    del params, opt
    torch.cuda.empty_cache()
    entry = kernel_entry(
        "lm_train", "flash_attention", "cuda",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:106",
        counts["flash_attention"], flash["err"], flash["ms"],
        flash["plain_ms"], flash["bound_ms"], flash["bound_by"],
        flash["library_ms"])
    # the kernel the path took, and the mma.sync kernel's time in this call
    entry.update(variant="wgmma", mma_ms=flash["mma_ms"])
    return [entry]


# ---------------------------------------------------------------------------
# LM serving: prefill and decode caches for global and sliding-window layers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def attention_routes():
    """While the block runs, count the calls of the chunked attention
    routes of ``models/layers.py``: ``_sdpa_flash`` by its
    ``dynamic_skip``, and ``_sdpa_window``."""
    from repro_torch.models import layers as L
    counts = {"flash": 0, "flash_skip": 0, "window": 0}
    orig = {n: getattr(L, n) for n in ("_sdpa_flash", "_sdpa_window")}

    def flash(*a, **kw):
        counts["flash_skip" if kw.get("dynamic_skip") else "flash"] += 1
        return orig["_sdpa_flash"](*a, **kw)

    def window(*a, **kw):
        counts["window"] += 1
        return orig["_sdpa_window"](*a, **kw)
    L._sdpa_flash, L._sdpa_window = flash, window
    try:
        yield counts
    finally:
        L._sdpa_flash, L._sdpa_window = orig["_sdpa_flash"], orig["_sdpa_window"]


def serve_perf(name, batch, params, cfg, tag="lm_serve"):
    """``serve`` at ``batch`` x SERVE_PROMPT tokens and SERVE_NEW new
    tokens in bf16 compute: the prefill's attention routes, no kernel
    launched, tokens in the vocabulary; prefill ms, decode ms a step,
    tokens/s and peak memory; a decode step twice from one cache bitwise;
    SERVE_PROFILE_STEPS decode steps under the profiler."""
    from repro_torch.configs import RunConfig
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import make_model
    run = RunConfig(seq_len=SERVE_PROMPT, global_batch=batch)
    prompts = TokenStream(vocab=cfg.vocab, seq_len=SERVE_PROMPT, batch=batch,
                          seed=SEED).batch_at(0)["tokens"]
    kinds = cfg.layer_kinds()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with attention_routes() as routes:
        toks, stats = serve(cfg, run, prompts, SERVE_NEW, device=DEV,
                            params=params)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_local = kinds.count("local")
    want = {"flash": 0, "flash_skip": kinds.count("global"),
            "window": n_local}
    log(f"[{tag}] {name}: serve({batch} x {SERVE_PROMPT}, {SERVE_NEW} new "
        f"tokens, {run.dtype} compute): prefill routes {routes} (want "
        f"{want}); launches {counts}")
    check(routes == want, f"{name}: prefill took routes {routes}, not {want}")
    check(sum(counts.values()) == 0, f"{name}: serving launched {counts}: "
          f"its path reaches no kernel")
    check(toks.shape == (batch, SERVE_NEW) and (toks >= 0).all() and
          (toks < cfg.vocab).all(), f"{name}: generated tokens {toks.shape} "
          f"outside [0, {cfg.vocab})")
    decode_ms = stats["decode_s"] / SERVE_NEW * 1e3
    log(f"[{tag}] {name}: prefill {stats['prefill_s'] * 1e3:.2f} ms, "
        f"decode {decode_ms:.3f} ms a step, {stats['tokens_per_s']:.1f} "
        f"tokens/s, peak memory {peak_gb:.2f} GB; continuation of prompt 0: "
        f"{toks[0, :8].tolist()}")

    model = make_model(cfg)
    s0 = SERVE_PROMPT
    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).to(DEV, torch.int64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model["prefill"](params, {"tokens": tokens}, run,
                                         s0 + SERVE_NEW)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        log(f"[{tag}] {name}: prefill again, warm: {warm_ms:.2f} ms")
        tok = torch.argmax(logits, -1)[:, None]
        twins = [[{k: t.clone() for k, t in c.items()} for c in cache]
                 for _ in range(2)]
        outs = [model["decode_step"](params, c, tok, s0, run) for c in twins]
        check(torch.equal(outs[0][0], outs[1][0]) and all(
            torch.equal(a[k], b[k]) for a, b in zip(*twins) for k in a),
            f"{name}: a decode step twice from one cache differs")
        del twins, outs
        log(f"[{tag}] {name}: a decode step twice from one cache: "
            f"logits and caches bitwise equal")
        state = {"tok": tok, "pos": s0}

        def decode_steps():
            for _ in range(SERVE_PROFILE_STEPS):
                lg, _ = model["decode_step"](params, cache, state["tok"],
                                             state["pos"], run)
                state["tok"] = torch.argmax(lg, -1)[:, None]
                state["pos"] += 1
        decode_steps()                                  # warm
        t0 = time.perf_counter()
        trace = profile_steps(decode_steps, SERVE_PROFILE_STEPS,
                              label=f"{tag} {name} decode trace")
        trace["seconds"] = time.perf_counter() - t0
        del cache
    idle = 1 - trace["busy_ms"] / trace["step_ms"] if trace["kernels"] \
        else "not measured"
    return dict(batch=batch, prompt_len=s0, new_tokens=SERVE_NEW,
                prefill_ms=stats["prefill_s"] * 1e3, prefill_warm_ms=warm_ms,
                decode_ms=decode_ms,
                tokens_per_s=stats["tokens_per_s"], peak_memory_gb=peak_gb,
                routes=routes, continuation=toks[0].tolist(),
                decode_trace=trace, decode_idle_share=idle)


def _tol_units(got, want, vocab):
    """The largest |got - want| over the vocabulary, in units of DECODE_TOL's
    atol + rtol |want|."""
    return ((got - want).abs() / (DECODE_TOL["atol"] + DECODE_TOL["rtol"]
                                  * want.abs()))[:, :vocab].max().item()


def serve_checks(name, cfg, params, greedy, **run_kw):
    """f32 compute at batch 2, for each of SERVE_CHECK_CASES (a prompt
    length, its attn_chunk, and a window for the local layers or the
    model's own): SERVE_CHECK_STEPS decode steps, teacher forced, after a
    chunked prefill, each step's logits against the last logits of a
    prefill of the growing prefix.  The power control runs the first step
    again from a copy of the prefill's cache in which the slot of the last
    prompt position is zeroed in every layer: one missing key, what a write
    clamped onto that slot does to the first step; it must leave the
    tolerance in both cases.  With
    ``greedy``, ``serve``'s greedy continuation of the 2 prompts against
    the argmax of prefill over the growing sequence, with the least top-2
    logit margin beside the largest logit shift of the control.
    ``run_kw`` sets further run knobs (an expert capacity)."""
    import dataclasses
    from repro_torch.configs import RunConfig
    from repro_torch.data import TokenStream
    from repro_torch.launch.serve import serve
    from repro_torch.models import make_model
    k, out = SERVE_CHECK_STEPS, {}
    for s0, chunk, window in SERVE_CHECK_CASES:
        c = cfg if window is None or not cfg.window else \
            dataclasses.replace(cfg, window=window)
        run = RunConfig(seq_len=s0, global_batch=2, dtype="float32",
                        attn_chunk=chunk, **run_kw)
        model = make_model(c)
        seq = torch.from_numpy(TokenStream(
            vocab=c.vocab, seq_len=s0 + k, batch=2, seed=SEED + 1)
            .batch_at(0)["tokens"]).to(DEV, torch.int64)
        case = out[s0] = {"attn_chunk": chunk, "window": c.window}
        with torch.inference_mode():
            with attention_routes() as routes:
                _, cache = model["prefill"](params, {"tokens": seq[:, :s0]},
                                            run, s0 + k)
            check(routes["flash_skip"] + routes["window"] == c.n_layers,
                  f"{name}: the {s0}-token prefill at chunk {chunk} was not "
                  f"chunked: {routes}")
            faulty = [{n: t.clone() for n, t in layer.items()}
                      for layer in cache]
            for layer, kind in zip(faulty, c.layer_kinds()):
                slot = (s0 - 1) % layer["k"].shape[2] if kind == "local" \
                    else s0 - 1
                layer["k"][:, :, slot] = 0
                layer["v"][:, :, slot] = 0
            worst = 0.0
            for i in range(k):
                pos = s0 + i
                dec, _ = model["decode_step"](params, cache,
                                              seq[:, pos:pos + 1], pos, run)
                full, _ = model["prefill"](
                    params, {"tokens": seq[:, :pos + 1]}, run)
                worst = max(worst, _tol_units(dec, full, c.vocab))
                if i == 0:
                    first = full
            ctl, _ = model["decode_step"](params, faulty, seq[:, s0:s0 + 1],
                                          s0, run)
            ctl_err = _tol_units(ctl, first, c.vocab)
            shift = (ctl - first)[:, :c.vocab].abs().max().item()
            rings = sorted({layer["k"].shape[2] for layer, kind in
                            zip(cache, c.layer_kinds()) if kind == "local"})
            del cache, faulty
        case.update(teacher_forced_worst=worst, control_one_missing_key=ctl_err,
                    control_max_logit_shift=shift)
        log(f"[lm_serve] {name}: {k} teacher-forced decode steps after a "
            f"chunked prefill of {s0} tokens ({routes}; local rings of "
            f"{rings} slots, written to position {s0 + k - 1}) against "
            f"prefill of the growing prefix, f32: worst |diff| {worst:.3e} of "
            f"atol + rtol |ref| (rtol = atol = 2e-3); the first step with "
            f"position {s0 - 1}'s key and value zeroed in every layer: "
            f"{ctl_err:.3e} of it, largest logit shift {shift:.3e}")
        check(worst <= 1.0, f"{name}: decode differs from prefill of the "
              f"growing prefix by {worst:.3e} of the tolerance")
        check(ctl_err > 1.0, f"{name}: one missing key moves the first "
              f"decode step's logits by only {ctl_err:.3e} of the tolerance "
              f"at a {s0}-token prompt")
        if greedy:
            served, _ = serve(c, run, seq[:, :s0].cpu().numpy(), k,
                              device=DEV, params=params)
            grown, margins = seq[:, :s0], []
            with torch.inference_mode():
                for _ in range(k):
                    lg, _ = model["prefill"](params, {"tokens": grown}, run)
                    top = torch.topk(lg, 2, dim=-1).values
                    margins.append((top[:, 0] - top[:, 1]).min().item())
                    grown = torch.cat([grown, torch.argmax(lg, -1)[:, None]],
                                      1)
            want = grown[:, s0:].cpu().numpy()
            log(f"[lm_serve] {name}: greedy serve of 2 x {s0} tokens, f32: "
                f"{served.tolist()}; prefill over the growing sequence: "
                f"{want.tolist()}; least top-2 logit margin "
                f"{min(margins):.3e} (one missing key shifts a logit by at "
                f"most {shift:.3e})")
            check(np.array_equal(served, want), f"{name}: serve's greedy "
                  f"continuation is not prefill's over the growing sequence")
            case.update(greedy_equal=True, greedy_min_margin=min(margins))
    return out


def gemma_train_step(report):
    """gemma3-4b at full width, one block cycle (5 local layers and 1
    global), batch 1 x 4,096, through ``train`` with ``flash_kernel``: the
    global layer's attention through the flash kernel's wgmma route (Dh
    256), once a forward; step 0's loss against the same step without the
    kernel; the kernel at the inputs the path handed it, against the plain
    version, timed beside the mma route, its bound and SDPA."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import batch_to
    from repro_torch.launch.train import train
    from repro_torch.models import make_model
    cfg = dataclasses.replace(get_arch("gemma3-4b"),
                              n_layers=len(get_arch("gemma3-4b").pattern))
    run = RunConfig(seq_len=GEMMA_SEQ, global_batch=1, flash_kernel=True)
    params = make_model(cfg)["init"](run, device=DEV)
    batch = batch_to(TokenStream(vocab=cfg.vocab, seq_len=GEMMA_SEQ, batch=1,
                                 seed=run.seed).batch_at(0), DEV)
    with torch.no_grad():
        l_plain = float(make_model(cfg)["train_loss"](
            params, batch, dataclasses.replace(run, flash_kernel=False)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with recording("flash_attention") as calls:
        params, opt, losses, tel = train(cfg, run, GEMMA_STEPS, device=DEV,
                                         params=params, log_every=0)
    counts, routes = ops.launch_counts(), ops.route_counts()["flash_attention"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params, opt
    torch.cuda.empty_cache()
    log(f"[lm_serve] gemma3-4b train step ({cfg.n_layers} layers: "
        f"{cfg.layer_kinds()}, batch 1 x {GEMMA_SEQ}, flash kernel): losses "
        f"{losses}; launches {counts}, flash routes {routes}")
    check(counts["flash_attention"] == GEMMA_STEPS and
          routes == {"wgmma": GEMMA_STEPS, "mma": 0},
          f"gemma3-4b: flash_attention launched {counts['flash_attention']} "
          f"times by route {routes}, not once a forward on wgmma")
    log(f"[lm_serve] gemma3-4b step 0's loss {losses[0]:.6f} through the "
        f"flash kernel, {l_plain:.6f} without (|diff| "
        f"{abs(losses[0] - l_plain):.2e}, tol {LM_LOSS_TOL} nats)")
    check(abs(losses[0] - l_plain) <= LM_LOSS_TOL,
          "gemma3-4b: the flash kernel's loss is off the plain path's")
    step_ms = tel.summary()["mean_s"] * 1e3
    (key, (a, kw, _)), = calls.items()
    q, k, v = (t.detach() for t in a)
    bh, s, dh = q.shape
    check(fa.route(q, k, v) == "wgmma", f"gemma3-4b: {key} not on wgmma")
    err = compare("flash_attention", f"gemma3-4b {tuple(q.shape)} wgmma",
                  fa.launch(q, k, v, True), ref.flash_attention(q, k, v),
                  FLASH_BF16_TOL)
    turns = {"wgmma": [], "mma": []}
    for rt in ("mma", "wgmma", "wgmma", "mma"):
        turns[rt].append(time_ms(lambda: fa.launch(q, k, v, True, route=rt),
                                 reps=20))
    t_k, t_m = (sum(turns[r]) / 2 for r in ("wgmma", "mma"))
    t_p = time_ms(lambda: ref.flash_attention(q, k, v), reps=5)
    q4, k4, v4 = (t.view(1, bh, s, dh) for t in (q, k, v))
    t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), reps=20)
    flops, (bms, by) = flash_bound(q, k, v)
    log(f"[times] flash_attention on gemma3-4b's global layer ({bh}, {s}, "
        f"{dh}) bf16 causal, wgmma route: {t_k:.4f} ms ({flops / t_k / 1e9:.1f} "
        f"TFLOP/s, {bms / t_k:.3f} of the bound), mma {t_m:.4f}, plain "
        f"{t_p:.4f}, SDPA {t_l:.4f}, bound {bms:.4f} ms ({by}); step "
        f"{step_ms:.2f} ms (mean of steps 1-{GEMMA_STEPS - 1}), peak memory "
        f"{peak_gb:.2f} GB")
    report["lm_serve"]["gemma3_train"] = dict(
        losses=losses, loss_plain=l_plain, launches=counts, routes=routes,
        step_ms=step_ms, step_times_s=tel.times, peak_memory_gb=peak_gb,
        flash_ms=t_k, mma_ms=t_m, turns=turns, plain_ms=t_p, library_ms=t_l,
        bound_ms=bms, bound_by=by, err=err)
    del q, k, v, q4, k4, v4, calls
    torch.cuda.empty_cache()
    entry = kernel_entry(
        "lm_train_gemma3", "flash_attention", "cuda",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:106", counts["flash_attention"],
        err, t_k, t_p, bms, by, t_l)
    entry.update(variant="wgmma", mma_ms=t_m)
    return entry


def lm_checkpoint(report):
    """olmo-1b at full width, depth cut to CKPT_LAYERS: CKPT_STEPS steps
    straight through, against CKPT_EVERY steps saved and the rest resumed
    in a fresh ``train`` call; the restored state bitwise the saved one,
    the resumed losses against the uninterrupted run's."""
    import dataclasses
    import tempfile
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.train import restore_state, train
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=CKPT_LAYERS)
    run = RunConfig(seq_len=LM_SEQ, global_batch=LM_BATCH, warmup=1,
                    flash_kernel=True)
    t0 = time.perf_counter()
    _, _, straight, _ = train(cfg, run, CKPT_STEPS, device=DEV, log_every=0)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="lm_ckpt-") as d:
        p1, o1, first, _ = train(cfg, run, CKPT_EVERY, device=DEV,
                                 log_every=0, checkpoint_dir=d,
                                 checkpoint_every=CKPT_EVERY)
        rp, ro, step = restore_state(cfg, CheckpointStore(d), DEV)
        same_state = step == CKPT_EVERY and ro["count"] == o1["count"] and \
            bitwise(list(rp.parameters()), list(p1.parameters())) and \
            bitwise(ro["mu"], o1["mu"]) and bitwise(ro["nu"], o1["nu"])
        check(same_state, "the restored parameters or AdamW state are not "
              "bitwise the saved ones")
        del p1, o1, rp, ro
        torch.cuda.empty_cache()
        _, o2, resumed, _ = train(cfg, run, CKPT_STEPS - CKPT_EVERY,
                                  device=DEV, log_every=0, checkpoint_dir=d,
                                  checkpoint_every=CKPT_EVERY)
        latest = CheckpointStore(d).latest()
    both = first + resumed
    diff = max(abs(a - b) for a, b in zip(both, straight))
    secs = time.perf_counter() - t0
    log(f"[lm_serve] checkpoint: {cfg.name} at {CKPT_LAYERS} layers, "
        f"{CKPT_STEPS} steps straight {straight}; {CKPT_EVERY} saved + "
        f"{CKPT_STEPS - CKPT_EVERY} resumed {both} (latest step {latest}, "
        f"AdamW count {o2['count']}); the restored state bitwise the saved "
        f"one; losses {'bitwise' if both == straight else 'not bitwise'}, "
        f"max |diff| {diff:.3e} (tol {RESUME_TOL}); {secs:.1f} s")
    check(latest == CKPT_STEPS and o2["count"] == CKPT_STEPS,
          f"resume ended at step {latest}, count {o2['count']}")
    check(diff <= RESUME_TOL, f"the resumed losses {both} are off the "
          f"uninterrupted run's {straight}")
    report["lm_serve"]["checkpoint"] = dict(
        straight=straight, resumed=both, bitwise=both == straight,
        max_diff=diff, seconds=secs)


def phase_lm_serve(report):
    """olmo-1b and gemma3-4b at full width and depth through ``serve``
    (bf16 compute; numbers and a decode profile), their f32 checks,
    gemma3-4b's training step through the flash kernel's wgmma route, and
    the trainer's checkpoint and resume."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models import make_model
    report["lm_serve"] = {}
    stage_s = report["lm_serve"]["stage_s"] = {}

    def timed(key, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        stage_s[key] = time.perf_counter() - t0
        return out
    for name, batch in SERVE_CASES:
        cfg = get_arch(name)
        t0 = time.perf_counter()
        params = make_model(cfg)["init"](RunConfig(), device=DEV)
        log(f"[lm_serve] {name}: {cfg.n_layers} layers "
            f"{''.join(k[0].upper() for k in cfg.layer_kinds())}, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} kv) of "
            f"{cfg.head_dim_}, window {cfg.window}, vocab {cfg.vocab}; "
            f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}B f32 "
            f"parameters")
        out = timed(f"{name} serve", serve_perf, name, batch, params, cfg)
        out.update(timed(f"{name} checks", serve_checks, name, cfg, params,
                         greedy=name == LM_ARCH))
        out["seconds"] = time.perf_counter() - t0
        report["lm_serve"][name] = out
        del params
        torch.cuda.empty_cache()
    entry = timed("gemma3-4b train", gemma_train_step, report)
    timed("checkpoint", lm_checkpoint, report)
    log(f"[lm_serve] seconds by stage: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in stage_s.items())}")
    return [entry]


# ---------------------------------------------------------------------------
# DCM-LDA: per-document topic-word tables through zstats' "runs" pass
# ---------------------------------------------------------------------------

def make_dcmlda():
    """DCM-LDA at benchmarks/bench_vmp.py's settings over DCM_DOCS
    documents: (corpus, model observed, its program)."""
    from repro_torch.core import models
    from repro_torch.data import SyntheticCorpus
    corpus = SyntheticCorpus(n_docs=DCM_DOCS, vocab=DCM_VOCAB,
                             n_topics=DCM_TOPICS, mean_len=DCM_MEAN_LEN,
                             seed=SEED).generate()
    m = models.make("dcmlda", alpha=ALPHA, beta=BETA, K=DCM_TOPICS,
                    V=DCM_VOCAB)
    m["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    return corpus, m, m.compile()


def phase_dcmlda(report):
    """DCM-LDA at benchmarks/bench_vmp.py's settings, depth DCM_DOCS
    documents: DCM_STEPS steps through ``Model.infer`` and ``get_result``
    with the launch counts set to 0 just before and read just after
    (``zstats`` once a step on the route ``explain_plan(backend="cuda")``
    names, the "runs" pass over the docs x topics child table), the ELBO
    monotone, both posteriors' stats summing to N, q(z) rows to 1, the
    digest; ``zstats``, the Elog passes and ``zstep`` against their plain
    versions at the inputs that the last step and ``get_result`` handed
    them (recorded as they ran), timed beside their bound; ms a step and
    the device's busy time under the profiler."""
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    corpus, m, prog = make_dcmlda()
    n = len(corpus["tokens"])
    log(f"[dcmlda] corpus D={DCM_DOCS} V={DCM_VOCAB} K={DCM_TOPICS} N={n} "
        f"tokens (phi on {DCM_DOCS * DCM_TOPICS} docs x topics rows), made "
        f"and compiled in {time.perf_counter() - t0:.1f} s")
    ops.reset_launch_counts()
    with recording("zstats", "dirichlet_expectation", "zstep") as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.infer(steps=DCM_STEPS, seed=SEED, device=DEV)
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        after_infer, routes = ops.launch_counts(), ops.route_counts()
        r = m["z"].get_result()
    counts = ops.launch_counts()
    trace = m.elbo_trace
    log(f"[dcmlda] infer(steps={DCM_STEPS}) {infer_s:.2f} s; ELBO "
        f"{trace[0]:.6e} -> {trace[-1]:.6e}; launches {counts}")
    check(after_infer["zstats"] == DCM_STEPS == routes["zstats"]["runs"],
          f"dcmlda: zstats launched {after_infer['zstats']} times in "
          f"{DCM_STEPS} steps, by pass {routes['zstats']}")
    check(counts["dirichlet_expectation"] > 0 and counts["zstep"] == 1,
          f"dcmlda: get_result('z') did not run the Triton kernels: {counts}")
    diffs = np.diff(trace)
    check(bool((diffs >= -1e-6 * abs(trace[-1])).all()),
          f"dcmlda: ELBO not monotone within 1e-6 relative: {diffs.tolist()}")
    posts = {name: m[name].get_result() for name in ("theta", "phi")}
    digest = output_digest(posts, trace)
    log(f"[dcmlda] sha256 of the final posteriors and ELBO trace: "
        f"{digest_note('dcmlda', digest)}")
    sums = {"theta": float(posts["theta"].sum(dtype=np.float64)) -
            posts["theta"].size * ALPHA,
            "phi": float(posts["phi"].sum(dtype=np.float64)) -
            posts["phi"].size * BETA}
    for name, s in sums.items():
        log(f"[dcmlda] sum of {name} stats {s:.1f} vs N = {n} "
            f"(rel {abs(s - n) / n:.2e}, tol 1e-5); {name} "
            f"{posts[name].shape}")
        check(abs(s - n) <= 1e-5 * n, f"dcmlda: {name} stats do not sum to N")
    row_err = float(np.abs(r.sum(axis=1, dtype=np.float64) - 1.0).max())
    check(r.shape == (n, DCM_TOPICS) and np.isfinite(r).all() and
          row_err <= 1e-5, "dcmlda: q(z) rows do not sum to 1")
    explain_check("dcmlda", m, routes, EXPECTED_ROUTE["dcmlda"])
    del posts, r
    log("[kernels vs plain] dcmlda: the inputs of its last step and of "
        "get_result('z')")
    entries = flat_recorded("dcmlda", calls, counts, "theta's (D, K) rows")
    entries += path_dirichlet_entries("dcmlda", prog, m._state, counts)
    theta_shape = (DCM_DOCS, DCM_TOPICS)
    (a, kw, _), = [v for (name, shape), v in calls.items()
                   if name == "dirichlet_expectation" and shape != theta_shape]
    phi = a[0]
    t_phi = time_ms(lambda: de.dirichlet_expectation(phi, **kw), reps=20)
    t_phi_dev = device_ms(lambda: de.dirichlet_expectation(phi, **kw))
    t_phi_plain = time_ms(lambda: de_plain(phi, kw.get("transpose", False))
                          .contiguous(), reps=5)
    phi_bound = work_bound("dirichlet_expectation", phi)
    log(f"  dirichlet_expectation on phi {tuple(phi.shape)} {kw}: "
        f"{t_phi:.4f} ms, device {t_phi_dev:.4f} ms, plain {t_phi_plain:.4f} "
        f"ms, bound {phi_bound[0]:.4f} ms ({phi_bound[1]})")
    del calls, a, phi
    t_step, step, st = time_steps(prog, m._state)
    trace_steps = phase_trace(step, st)
    log(f"[dcmlda] VMP step {t_step:.2f} ms, {n / t_step * 1e3:.4e} tokens/s, "
        f"device busy {trace_steps['busy_ms']:.3f} ms a step")
    report["dcmlda"] = dict(
        n_tokens=n, launches=counts, routes=routes, elbo_trace=trace,
        digest=digest, stats_sums=sums, infer_s=infer_s, step_ms=t_step,
        tokens_per_s=n / t_step * 1e3, trace=trace_steps,
        phi_elog=dict(ms=t_phi, device_ms=t_phi_dev, plain_ms=t_phi_plain,
                      bound_ms=phi_bound[0], bound_by=phi_bound[1]))
    del m, prog, step, st, corpus
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# the Dirichlet terms: each table's ELBO term and its prior + stats update
# ---------------------------------------------------------------------------

# (rows, columns, Elog a transposed view) of the benchmark's tables:
# dcmlda-nips' phi, lda-nytimes' phi (stored (V, K), read as (K, V)) and
# its theta
DIRICHLET_TABLES = {"dcmlda-nips phi": (150000, 12419, False),
                    "lda-nytimes phi": (100, 102660, True),
                    "lda-nytimes theta": (300000, 100, False)}
# the ELBO term's largest error against an f64 evaluation as a share of the
# sum of its parts' magnitudes (sum |lgamma(post)| + sum |post * elog|),
# beside ``dirichlet_terms.error_limit`` (set by the plain f32 version's
# own error): 1e-7 of dcmlda-nips' phi is some 2,000 nats, a third of one
# of its rows
DIRICHLET_TOL = 1e-7
DIRICHLET_SRC = "src/repro_torch/kernels/dirichlet_terms.py"
DIRICHLET_REPLACES = "none (the JAX package leaves it to XLA)"


def dirichlet_table(g, k, transpose, seed=SEED):
    """(prior row, posterior, its Elog table, stats) of a (g, k) Dirichlet
    at the benchmark's prior (BETA), a fifth of its cells counted; with
    ``transpose`` the Elog table is the (g, k) view of a (k, g) one."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=DEV).manual_seed(seed)
    prior = torch.full((1, k), BETA, device=DEV)
    stats = torch.rand((g, k), generator=gen, device=DEV)
    stats = torch.where(stats < 0.2, stats * 40.0, 0.0)
    post = ref.dirichlet_update(prior, stats)
    elog = ops.dirichlet_expectation(post, transpose=transpose)
    return prior, post, elog.T if transpose else elog, stats


def f64_elbo_term(prior, post, elog, rows=4096):
    """(the ELBO term in f64, the sum of its parts' magnitudes), by blocks
    of ``rows`` rows."""
    from repro_torch.kernels import ref
    p64, total, scale = prior.double(), 0.0, 0.0
    for lo in range(0, post.shape[0], rows):
        a, e = post[lo:lo + rows].double(), elog[lo:lo + rows].double()
        total += float(ref.dirichlet_elbo_term(p64, a, e))
        scale += float(torch.lgamma(a).abs().sum() + (a * e.abs()).sum())
    return total, scale


def dirichlet_terms_check(tag, prior, post, elog, stats):
    """The Dirichlet terms' kernels on one table, through ``ops``: the ELBO
    term within ``dirichlet_terms.error_limit`` and DIRICHLET_TOL of an
    f64 evaluation (the plain f32 version's error beside it) and twice
    bitwise; the update bitwise the plain ``prior * ones + stats``, twice
    bitwise; each timed (CUDA events, and device time in a CUDA graph)
    beside its plain version and its bound (``kernels/work.py``).  Returns
    the ELBO term's numbers and ``{kernel: times}``."""
    from repro_torch.kernels import dirichlet_terms as dt
    from repro_torch.kernels import ops, ref
    term = ops.dirichlet_elbo_term(prior, post, elog)
    again = ops.dirichlet_elbo_term(prior, post, elog)
    upd = ops.dirichlet_update(prior, stats)
    check(torch.equal(term, again)
          and torch.equal(upd, ops.dirichlet_update(prior, stats)),
          f"dirichlet_terms {tag}: two calls differ")
    check(torch.equal(upd, ref.dirichlet_update(prior, stats)),
          f"dirichlet_terms {tag}: the update is not prior * ones + stats "
          f"bit for bit")
    del upd
    truth, scale = f64_elbo_term(prior, post, elog)
    plain = float(ref.dirichlet_elbo_term(prior, post, elog))
    err, plain_err = abs(float(term) - truth), abs(plain - truth)
    limit = dt.error_limit(plain_err, truth)
    log(f"  dirichlet_elbo_term {tag}: {float(term):.9e}, f64 {truth:.9e}, "
        f"plain f32 {plain:.9e}; error {err:.3e} (plain {plain_err:.3e}, "
        f"limit {limit:.3e}), {err / scale:.2e} of the parts' {scale:.3e} "
        f"(tol {DIRICHLET_TOL})")
    check(err <= limit and err <= DIRICHLET_TOL * scale,
          f"dirichlet_elbo_term {tag} is off its f64 evaluation")
    times = {}
    for name, fn, plain_fn, work_args in (
            ("dirichlet_elbo_term",
             lambda: ops.dirichlet_elbo_term(prior, post, elog),
             lambda: ref.dirichlet_elbo_term(prior, post, elog),
             (post, elog)),
            ("dirichlet_update",
             lambda: ops.dirichlet_update(prior, stats),
             lambda: ref.dirichlet_update(prior, stats), (stats,))):
        ms, dev_ms = time_ms(fn, reps=20), device_ms(fn, reps=3)
        plain_ms = time_ms(plain_fn, reps=3)
        bound_ms, bound_by = work_bound(name, *work_args)
        log(f"  {name} {tag}: {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}): "
            f"{bound_ms / dev_ms:.1%} of its roofline")
        times[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
    numbers = dict(value=float(term), f64=truth, plain=plain, err=err,
                   plain_err=plain_err, limit=limit, scale=scale)
    return numbers, times


def dirichlet_entries(path, routes, err, times, counts):
    """The kernels-line entries of the Dirichlet terms' kernels on ``path``
    (the ELBO term on its table's route), with the launch ``counts`` of
    that path's own run."""
    entries = []
    for name, t in times.items():
        entry = kernel_entry(
            path, name, routes if name == "dirichlet_elbo_term" else "flat",
            DIRICHLET_SRC, DIRICHLET_REPLACES, counts[name],
            err if name == "dirichlet_elbo_term" else 0.0, t["ms"],
            t["plain_ms"], t["bound_ms"], t["bound_by"])
        entry["device_ms"] = t["device_ms"]
        entries.append(entry)
    return entries


def path_dirichlet_entries(label, prog, state, counts):
    """The Dirichlet terms' kernels on path ``label`` at its largest
    Dirichlet table of ``state`` and that table's Elog table as the step
    makes it (``vmp._elog_tables``: phi's a transposed view where the
    path's child is specialized), checked and timed
    (:func:`dirichlet_terms_check`): the kernels-line entries with the
    launch ``counts`` of the path's own run, each at least one a step."""
    from repro_torch.core import vmp
    from repro_torch.kernels import dirichlet_terms as dt
    name = max(state.posteriors, key=lambda n: state.posteriors[n].numel())
    post = state.posteriors[name]
    elog = vmp._elog_tables(prog, state)[name]
    prior = vmp._prior(prog.dirichlets[name], post.device)
    stats = post - prior
    g, k = post.shape
    route = dt.elbo_plan(g, k, dt.transposed(elog), dt._n_sm(post.device))
    log(f"[kernels vs plain] {label}: the Dirichlet terms on {name} "
        f"{(g, k)}, route {route.route}; launches "
        f"{counts['dirichlet_elbo_term']} and {counts['dirichlet_update']}")
    check(counts["dirichlet_elbo_term"] > 0 and counts["dirichlet_update"] > 0,
          f"{label}: the Dirichlet terms' kernels did not run: {counts}")
    numbers, times = dirichlet_terms_check(f"{label} {name} {(g, k)}", prior,
                                           post, elog, stats)
    del post, elog, prior, stats
    return dirichlet_entries(label, route.route, numbers["err"], times,
                             counts)


def phase_dirichlet_terms(report):
    """The Dirichlet terms' Triton kernels (``kernels/dirichlet_terms.py``)
    at the benchmark's tables (DIRICHLET_TABLES), each through
    :func:`dirichlet_terms_check`, the ELBO term on the route its plan
    names and exactly 0 on a table that is all prior.  The kernels-line
    entries are the path ``dirichlet_terms``'s, one per table and kernel
    (its ``"table"``), with the launches of the table's first calls."""
    from repro_torch.kernels import dirichlet_terms as dt
    from repro_torch.kernels import ops
    out = report["dirichlet_terms"] = {}
    entries = []
    log(f"[dirichlet_terms] {device_line()}")
    for label, (g, k, transpose) in DIRICHLET_TABLES.items():
        prior, post, elog, stats = dirichlet_table(g, k, transpose)
        plan = dt.elbo_plan(g, k, transpose, dt._n_sm(post.device))
        ops.reset_launch_counts()
        numbers, times = dirichlet_terms_check(label, prior, post, elog,
                                               stats)
        counts, routes = ops.launch_counts(), ops.route_counts()
        log(f"  {label} {(g, k)}: route {plan.route} ({plan.chunks} chunks "
            f"of {plan.chunk_cols} columns, tiles {plan.block}, "
            f"{plan.warps} warps); the checks' launches "
            f"{counts['dirichlet_elbo_term']} and {counts['dirichlet_update']}")
        check(routes["dirichlet_elbo_term"][plan.route]
              == counts["dirichlet_elbo_term"] > 0,
              f"dirichlet_terms {label}: routes {routes}, planned "
              f"{plan.route}")
        flat = prior.expand(g, k).contiguous()
        zero = float(ops.dirichlet_elbo_term(prior, flat, elog))
        check(zero == 0.0, f"dirichlet_terms {label}: a table that is all "
              f"prior gives {zero}, not 0")
        del flat
        for entry in dirichlet_entries("dirichlet_terms", plan.route,
                                       numbers["err"], times, counts):
            entry["table"] = label
            entries.append(entry)
        out[label] = dict(shape=(g, k), transposed=transpose,
                          launches=counts, **numbers, **times)
        del prior, post, elog, stats
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# DCM-SLDA: sentence topics over per-document phi, phase 2b on "runs"
# ---------------------------------------------------------------------------

def make_dcmslda():
    """DCM-SLDA at DCM-LDA's settings (:func:`make_dcmlda`'s corpus), each
    document cut into sentences of SENT_LEN tokens: (corpus, sentence count,
    model observed, its program)."""
    from repro_torch.core import models
    from repro_torch.data import SyntheticCorpus
    corpus = SyntheticCorpus(n_docs=DCM_DOCS, vocab=DCM_VOCAB,
                             n_topics=DCM_TOPICS, mean_len=DCM_MEAN_LEN,
                             seed=SEED).generate()
    tok_sent, sent_doc = sentences(corpus)
    m = models.make("dcmslda", alpha=ALPHA, beta=BETA, K=DCM_TOPICS,
                    V=DCM_VOCAB)
    m["x"].observe(corpus["tokens"], segment_ids=tok_sent)
    m.bind("sents", sent_doc)
    return corpus, len(sent_doc), m, m.compile()


def phase2b_ms(args, plan, reps=20):
    """ms of ``zstats_zmap``'s phase 2b alone at ``args`` under ``plan``
    (the one zmap child's zero fill and stats pass,
    ``fused_zmap._stats_pass``) and of the zero fill alone, CUDA events
    around back-to-back calls.  r is a seeded uniform table of the call's
    shape: the pass's time depends on the streams, not on r's values."""
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import fused_zstats as fz
    prior, rows, children, _ = args
    (c,) = [c for c in children if c.zmap is not None]
    gen = torch.Generator(device=prior.device).manual_seed(SEED)
    r = torch.rand((rows.shape[0], prior.shape[1]), generator=gen,
                   device=prior.device)
    zargs = fz.make_args(prior.shape[1], (c,), (c.elog,))
    lib, stream = fz.library(), torch.cuda.current_stream().cuda_stream
    both = time_ms(lambda: fzm._stats_pass(lib, zargs, plan, 0, c, r, stream),
                   reps=reps)
    fill = time_ms(lambda: torch.zeros(c.elog.shape, dtype=torch.float32,
                                       device=prior.device), reps=reps)
    return dict(phase2b_ms=both, fill_ms=fill, pass_ms=both - fill)


def phase_dcmslda(report):
    """DCM-SLDA at DCM-LDA's settings, sentences of SENT_LEN tokens:
    DCM_STEPS steps through ``Model.infer`` and ``get_result`` with the
    launch counts set to 0 just before and read just after
    (``zstats_zmap`` once a step, phi's phase 2b on the "runs" pass that
    ``explain_plan(backend="cuda")`` names), the ELBO monotone, theta's
    stats summing to the sentences and phi's to N, q(z) rows to 1, the
    digest; at the inputs that the last step handed ``zstats_zmap``: the
    kernel against ``ref.zstats``, twice bitwise and bitwise the per-column
    pass, both timed (the call, and phase 2b alone) beside their bounds;
    ``zmap_logits``, ``zstep`` and the Elog passes at the inputs
    ``get_result`` and the last step handed them; ms a step and the
    device's busy time under the profiler."""
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ops, ref, work
    from repro_torch.kernels import vmp_zstep as zs
    from repro_torch.launch.roofline import bound
    t0 = time.perf_counter()
    corpus, n_sent, m, prog = make_dcmslda()
    n = len(corpus["tokens"])
    log(f"[dcmslda] corpus D={DCM_DOCS} V={DCM_VOCAB} K={DCM_TOPICS} N={n} "
        f"tokens in {n_sent} sentences of <= {SENT_LEN} (phi on "
        f"{DCM_DOCS * DCM_TOPICS} docs x topics rows), made and compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    ops.reset_launch_counts()
    with recording("zstats", "dirichlet_expectation", "zmap_logits",
                   "zstep") as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.infer(steps=DCM_STEPS, seed=SEED, device=DEV)
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        after_infer, routes = ops.launch_counts(), ops.route_counts()
        r = m["z"].get_result()
    counts = ops.launch_counts()
    trace = m.elbo_trace
    log(f"[dcmslda] infer(steps={DCM_STEPS}) {infer_s:.2f} s; ELBO "
        f"{trace[0]:.6e} -> {trace[-1]:.6e}; launches {counts}")
    zr = routes["zstats_zmap"]
    check(after_infer["zstats_zmap"] == DCM_STEPS == zr["runs"] == zr["group"]
          and after_infer["zstats"] == 0,
          f"dcmslda: zstats_zmap launched {after_infer['zstats_zmap']} times "
          f"in {DCM_STEPS} steps, by route {zr}")
    check(counts["dirichlet_expectation"] > 0 and counts["zstep"] == 1
          and counts["zmap_logits"] == 1,
          f"dcmslda: get_result('z') did not run zmap_logits and zstep: "
          f"{counts}")
    diffs = np.diff(trace)
    check(bool((diffs >= -1e-6 * abs(trace[-1])).all()),
          f"dcmslda: ELBO not monotone within 1e-6 relative: "
          f"{diffs.tolist()}")
    posts = {name: m[name].get_result() for name in ("theta", "phi")}
    digest = output_digest(posts, trace)
    log(f"[dcmslda] sha256 of the final posteriors and ELBO trace: "
        f"{digest_note('dcmslda', digest)}")
    sums = {"theta": float(posts["theta"].sum(dtype=np.float64)) -
            posts["theta"].size * ALPHA,
            "phi": float(posts["phi"].sum(dtype=np.float64)) -
            posts["phi"].size * BETA}
    for name, want in (("theta", n_sent), ("phi", n)):
        s = sums[name]
        log(f"[dcmslda] sum of {name} stats {s:.1f} vs {want} (rel "
            f"{abs(s - want) / want:.2e}, tol 1e-5); {name} "
            f"{posts[name].shape}")
        check(abs(s - want) <= 1e-5 * want,
              f"dcmslda: {name} stats do not sum to {want}")
    row_err = float(np.abs(r.sum(axis=1, dtype=np.float64) - 1.0).max())
    log(f"[dcmslda] q(z) {r.shape}: max |row sum - 1| = {row_err:.2e} (tol "
        f"1e-5)")
    check(r.shape == (n_sent, DCM_TOPICS) and np.isfinite(r).all() and
          row_err <= 1e-5, "dcmslda: q(z) rows do not sum to 1")
    explain_check("dcmslda", m, routes, EXPECTED_ROUTE["dcmslda"])
    del posts, r

    log("[kernels vs plain] dcmslda: the inputs of its last step and of "
        "get_result('z')")
    args, plan = replayed("dcmslda", calls)
    zerr, plan, col = zmap_runs_check("dcmslda inputs", args, plan)
    zkids = tuple(c for c in args[2] if c.zmap is not None)
    g = plan.by_value[0]
    run_len = np.diff(g.key_start)
    col_len = np.bincount(zkids[0].values.cpu().numpy(),
                          minlength=DCM_VOCAB)
    log(f"  phi's child: {g.n_keys} (document, word) runs, longest "
        f"{run_len.max()}, mean {run_len.mean():.4f} tokens; hottest value "
        f"column {col_len.max()} tokens")
    t_runs = time_ms(lambda: fzm.zstats_zmap(*args, plan=plan), reps=20)
    t_col = time_ms(lambda: fzm.zstats_zmap(*args, plan=col), reps=5)
    t_plain = time_ms(lambda: ref.zstats(*args), reps=3)
    split = {kind: phase2b_ms(args, p) for kind, p in (("runs", plan),
                                                        ("strided", col))}
    z_bound = work_bound("zstats_zmap", *args)
    p_bound = bound(*work.zmap_stats(zkids, args[1].shape[0],
                                     args[0].shape[1])[::-1])
    log(f"  zstats_zmap dcmslda: runs {t_runs:.4f} ms, per column "
        f"{t_col:.4f} ms, plain {t_plain:.4f} ms, bound {z_bound[0]:.4f} ms "
        f"({z_bound[1]})")
    for kind, sp in split.items():
        log(f"  phase 2b alone on {kind}: {sp['phase2b_ms']:.4f} ms, the "
            f"zero fill {sp['fill_ms']:.4f} ms and the pass "
            f"{sp['pass_ms']:.4f} ms (CUDA events, 20 calls); phase 2b's "
            f"bound {p_bound[0]:.4f} ms ({p_bound[1]})")
    del col
    # get_result's zmap_logits and zstep, the Elog passes of the last step
    (lkids, n_inst, k), lkw, lout = calls["zmap_logits",
                                         tuple(zkids[0].elog.shape)]
    lerr = compare("zmap_logits", "dcmslda get_result", lout,
                   ref.zmap_logits(lkids, n_inst, k),
                   dict(rtol=ZSTATS_TOL["rtol"], atol=ZSTATS_TOL["atol"]))
    t_l = time_ms(lambda: fzm.zmap_logits(lkids, n_inst, k, **lkw), reps=10)
    t_lp = time_ms(lambda: ref.zmap_logits(lkids, n_inst, k), reps=3)
    (logits,), _, (rz, lse) = [v for (nm, _), v in calls.items()
                               if nm == "zstep"][0]
    rp, lp = ref.zstep(logits)
    s_err = max(compare("zstep", f"dcmslda r {tuple(logits.shape)}", rz, rp,
                        ZSTEP_TOL),
                compare("zstep", "dcmslda lse", lse, lp,
                        dict(rtol=1e-5, atol=1e-5)))
    t_s = time_ms(lambda: zs.zstep(logits), reps=20)
    t_sp = time_ms(lambda: ref.zstep(logits), reps=5)
    de_err = 0.0
    for (nm, shape), (a, kw, out) in calls.items():
        if nm == "dirichlet_expectation":
            de_err = max(de_err, compare(
                nm, f"dcmslda {shape}", out,
                de_plain(a[0], kw.get("transpose", False)), DE_TOL))
    (a, kw, _), = [v for (nm, shape), v in calls.items()
                   if nm == "dirichlet_expectation"
                   and shape == tuple(zkids[0].elog.shape)]
    phi = a[0]
    t_de = time_ms(lambda: de.dirichlet_expectation(phi, **kw), reps=20)
    t_de_dev = device_ms(lambda: de.dirichlet_expectation(phi, **kw))
    t_dep = time_ms(lambda: de_plain(phi, kw.get("transpose", False))
                    .contiguous(), reps=5)
    entries = []
    src = "src/repro_torch/kernels/csrc/zstats.cu"
    for name, route, source, rep, ms, pms, (bms, by), e in [
        ("zstats_zmap", "cuda", src, "src/repro/kernels/fused_zmap.py:236",
         t_runs, t_plain, z_bound, zerr),
        ("zmap_logits", "cuda", src, "src/repro/kernels/fused_zmap.py:165",
         t_l, t_lp, work_bound("zmap_logits", lkids, n_inst, k), lerr),
        ("dirichlet_expectation", "triton",
         "src/repro_torch/kernels/dirichlet_expectation.py",
         "src/repro/kernels/dirichlet_expectation.py:52", t_de, t_dep,
         work_bound("dirichlet_expectation", phi), de_err),
        ("zstep", "triton", "src/repro_torch/kernels/vmp_zstep.py",
         "src/repro/kernels/vmp_zstep.py:40", t_s, t_sp,
         work_bound("zstep", logits), s_err),
    ]:
        entries.append(kernel_entry("dcmslda", name, route, source, rep,
                                    counts[name], e, ms, pms, bms, by))
        log(f"  {name:<22} {ms:9.4f} ms  plain {pms:9.4f} ms  bound "
            f"{bms:8.4f} ms ({by})  launches {counts[name]}")
    entries[0].update(variant=EXPECTED_ROUTE["dcmslda"], strided_ms=t_col)
    entries[2]["device_ms"] = t_de_dev
    log(f"  dirichlet_expectation on phi {tuple(phi.shape)}: device time "
        f"{t_de_dev:.4f} ms a call (CUDA graph of 20 calls)")
    entries += path_dirichlet_entries("dcmslda", prog, m._state, counts)
    del calls, a, phi, logits, args, plan, lkids, lout, rz, lse, rp, lp
    t_step, step, st = time_steps(prog, m._state)
    trace_steps = phase_trace(step, st)
    log(f"[dcmslda] VMP step {t_step:.2f} ms, {n / t_step * 1e3:.4e} "
        f"tokens/s, device busy {trace_steps['busy_ms']:.3f} ms a step")
    report["dcmslda"] = dict(
        n_tokens=n, n_sentences=n_sent, launches=counts, routes=routes,
        elbo_trace=trace, digest=digest, stats_sums=sums, infer_s=infer_s,
        step_ms=t_step, tokens_per_s=n / t_step * 1e3, trace=trace_steps,
        zstats_zmap=dict(runs_ms=t_runs, strided_ms=t_col, plain_ms=t_plain,
                         bound_ms=z_bound[0], bound_by=z_bound[1],
                         phase2b_bound_ms=p_bound[0],
                         phase2b_bound_by=p_bound[1], split=split,
                         n_runs=g.n_keys, longest_run=int(run_len.max()),
                         hottest_column=int(col_len.max())))
    del m, prog, step, st, corpus
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# experts: qwen3-moe and moonshot serving and training
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def moe_routes():
    """While the block runs, every routing call of ``models/layers.py``
    (``_route_from_logits``) passes through unchanged and is kept in call
    order: ``[(logits, k, cap, take, w_slot)]``, tensors on the card."""
    from repro_torch.models import layers as L
    orig, calls = L._route_from_logits, []

    def route(logits, k, cap):
        out = orig(logits, k, cap)
        calls.append((logits, k, cap, out[0], out[1]))
        return out
    L._route_from_logits = route
    try:
        yield calls
    finally:
        L._route_from_logits = orig


def dropped_share(calls):
    """The share of the calls' (token, expert) assignments that found no
    slot."""
    kept = sum(int((take < logits.shape[0]).sum())
               for logits, _, _, take, _ in calls)
    total = sum(logits.shape[0] * k for logits, k, _, _, _ in calls)
    return 1 - kept / total


def np_route(logits, k, cap):
    """``_moe_route`` of the reference recomputed on the host from router
    logits (n, E) f32: top-k by a stable sort (the lower expert first on a
    tie), an f64 softmax over the selected logits, a stable sort of the
    expert ids, slots ``pos < cap``; ``(take, w_slot)``."""
    n, e = logits.shape
    ids = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    top = np.take_along_axis(logits, ids, -1).astype(np.float64)
    w = np.exp(top - top.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    flat_e = ids.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    se = flat_e[order]
    st = np.repeat(np.arange(n), k)[order]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(se, minlength=e))[:-1]])
    pos = np.arange(n * k) - offsets[se]
    keep = pos < cap
    slot = se[keep] * cap + pos[keep]
    take, w_slot = np.full(e * cap, n), np.zeros(e * cap)
    take[slot], w_slot[slot] = st[keep], w.reshape(-1)[order][keep]
    return take.reshape(e, cap), w_slot.reshape(e, cap)


def moe_routing_check(name, cfg, params):
    """At the default capacity in f32, batch 2: a 1,024-token prefill and
    one decode step, the routing arrays of every layer's call (``take``,
    ``w_slot``) against :func:`np_route` on the same router logits (take
    bitwise, w_slot within ROUTE_W_TOL), the share of dropped assignments
    in each, and the decode step twice from one cache bitwise."""
    from repro_torch.configs import RunConfig
    from repro_torch.data import TokenStream
    from repro_torch.models import make_model
    s0 = SERVE_CHECK_CASES[0][0]
    run = RunConfig(seq_len=s0, global_batch=2, dtype="float32",
                    attn_chunk=SERVE_CHECK_CASES[0][1])
    model = make_model(cfg)
    seq = torch.from_numpy(TokenStream(vocab=cfg.vocab, seq_len=s0 + 1,
                                       batch=2, seed=SEED + 2)
                           .batch_at(0)["tokens"]).to(DEV, torch.int64)
    with torch.inference_mode():
        with moe_routes() as pre:
            _, cache = model["prefill"](params, {"tokens": seq[:, :s0]}, run,
                                        s0 + 1)
        twins = [[{k: t.clone() for k, t in c.items()} for c in cache]
                 for _ in range(2)]
        with moe_routes() as dec:
            out = model["decode_step"](params, twins[0], seq[:, s0:], s0, run)
        again = model["decode_step"](params, twins[1], seq[:, s0:], s0, run)
    check(torch.equal(out[0], again[0]) and all(
        torch.equal(a[k], b[k]) for a, b in zip(*twins) for k in a),
        f"{name}: a decode step twice from one cache differs")
    worst = 0.0
    for what, calls in (("prefill", pre), ("decode", dec)):
        check(len(calls) == cfg.n_layers, f"{name}: {len(calls)} routing "
              f"calls in one {what}, not one a layer")
        for logits, k, cap, take, w_slot in calls:
            want_t, want_w = np_route(logits.cpu().numpy(), k, cap)
            check(np.array_equal(take.cpu().numpy(), want_t),
                  f"{name}: the card's take in {what} is not the host's")
            err = float(np.abs(w_slot.double().cpu().numpy() - want_w).max())
            check(err <= ROUTE_W_TOL, f"{name}: w_slot in {what} off the "
                  f"host's by {err:.3e}")
            worst = max(worst, err)
    shares = {"prefill": dropped_share(pre), "decode": dropped_share(dec)}
    caps = {"prefill": pre[0][2], "decode": dec[0][2]}
    log(f"[lm_moe] {name}: routing at the default capacity (f32, 2 x {s0} "
        f"prefill, one decode step of 2 tokens; slots an expert {caps}): "
        f"take bitwise and w_slot within {worst:.3e} of the host's "
        f"recomputation in all {2 * cfg.n_layers} calls; dropped "
        f"assignments {shares}; a decode step twice bitwise")
    return dict(w_slot_worst=worst, dropped_share=shares, capacity=caps)


def moe_serve(report):
    """qwen3-moe at full width, depth MOE_SERVE_LAYERS, through ``serve``
    (:func:`serve_perf`: prefill, decode, tokens/s, the decode profile,
    peak memory, a decode step twice bitwise), then the share of dropped
    assignments at the default capacity in one prefill of its prompts and
    one decode step after it."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.data import TokenStream
    from repro_torch.models import make_model
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_SERVE_LAYERS)
    params = make_model(cfg)["init"](RunConfig(), device=DEV)
    log(f"[lm_moe] {cfg.name}: {cfg.n_layers} of 48 layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} kv) of "
        f"{cfg.head_dim_}, {cfg.n_experts} experts top-{cfg.experts_per_tok} "
        f"of d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}B f32 "
        f"parameters")
    out = serve_perf(cfg.name, MOE_SERVE_BATCH, params, cfg)
    run = RunConfig(seq_len=SERVE_PROMPT, global_batch=MOE_SERVE_BATCH)
    model = make_model(cfg)
    tokens = torch.from_numpy(TokenStream(
        vocab=cfg.vocab, seq_len=SERVE_PROMPT, batch=MOE_SERVE_BATCH,
        seed=SEED).batch_at(0)["tokens"]).to(DEV, torch.int64)
    with torch.inference_mode():
        with moe_routes() as pre:
            logits, cache = model["prefill"](params, {"tokens": tokens}, run,
                                             SERVE_PROMPT + 1)
        with moe_routes() as dec:
            model["decode_step"](params, cache, torch.argmax(logits, -1)[
                :, None], SERVE_PROMPT, run)
        shares = {"prefill": dropped_share(pre), "decode": dropped_share(dec)}
        caps = {"prefill": pre[0][2], "decode": dec[0][2]}
    del pre, dec, cache, params
    torch.cuda.empty_cache()
    log(f"[lm_moe] {cfg.name}: dropped assignments at the default capacity "
        f"{RunConfig().moe_capacity} (slots an expert {caps}): {shares}")
    out.update(dropped_share=shares, capacity=caps, layers=cfg.n_layers)
    report["lm_moe"]["serve"] = out


def moe_checks(report, name):
    """``name`` at full width, MOE_LAYERS layers, f32: :func:`serve_checks`
    at ``moe_capacity = E/k`` (decode against prefill of the growing prefix
    within DECODE_TOL, with the zeroed-key control), then
    :func:`moe_routing_check` at the default capacity."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models import make_model
    cfg = dataclasses.replace(get_arch(name), n_layers=MOE_LAYERS)
    params = make_model(cfg)["init"](RunConfig(), device=DEV)
    no_drop = cfg.n_experts / cfg.experts_per_tok
    log(f"[lm_moe] {name}: {cfg.n_experts} experts top-"
        f"{cfg.experts_per_tok}, {cfg.n_heads} heads ({cfg.n_kv_heads} kv), "
        f"d_ff {cfg.d_ff}, {MOE_LAYERS} layers; decode against prefill at "
        f"moe_capacity = E/k = {no_drop:.4f}, where no assignment is dropped")
    out = serve_checks(name, cfg, params, greedy=False, moe_capacity=no_drop)
    out["routing"] = moe_routing_check(name, cfg, params)
    del params
    torch.cuda.empty_cache()
    report["lm_moe"][name] = out


def host_params(module):
    return [p.detach().cpu() for p in module.parameters()]


def microbatch_loss(cfg, run):
    """The first step's loss of ``run.microbatch`` slices as the trainer
    must compose it: each slice of batch 0 through ``train_loss`` at the
    initial parameters, ``loss / k`` added to an f32 zero in slice
    order."""
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import batch_to
    from repro_torch.models import make_model
    model, k = make_model(cfg), run.microbatch
    params = model["init"](run, device=DEV)
    batch = batch_to(TokenStream(vocab=cfg.vocab, seq_len=run.seq_len,
                                 batch=run.global_batch, seed=run.seed)
                     .batch_at(0), DEV)
    b = run.global_batch
    total = torch.zeros((), dtype=torch.float32, device=DEV)
    with torch.no_grad():
        for i in range(k):
            part = {key: v[i * b // k:(i + 1) * b // k]
                    for key, v in batch.items()}
            total = total + model["train_loss"](params, part, run) / k
    del params
    return float(total)


def moe_train(report):
    """qwen3-moe at full width, MOE_LAYERS layers, through ``train`` with
    the flash kernel (the wgmma route), MOE_STEPS steps from the port's
    seeded initialisation for each of MOE_TRAIN_RUNS, launch counts set to
    0 just before each and read just after: the plain run twice bitwise
    (losses and parameters), the remat runs bitwise the plain run,
    microbatch 2's first loss within MOE_MB_TOL of it; ms a step, tokens/s
    and peak memory of each; the kernel at the inputs the plain run handed
    it against its plain version, timed beside its bound, the mma route
    and SDPA."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import train
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
    base = RunConfig(seq_len=MOE_SEQ, global_batch=MOE_BATCH, warmup=1,
                     flash_kernel=True)
    tokens = MOE_BATCH * MOE_SEQ
    runs, launches, plain, flash_calls = {}, {}, None, None
    for label, kw in MOE_TRAIN_RUNS:
        run = dataclasses.replace(base, **kw)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with recording("flash_attention") as calls:
            params, opt, losses, tel = train(cfg, run, MOE_STEPS, device=DEV,
                                             log_every=0)
        counts, routes = ops.launch_counts(), ops.route_counts()[
            "flash_attention"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # once a layer a forward; remat's recompute and each microbatch
        # forward launch it again
        want = cfg.n_layers * MOE_STEPS * (1 if label.startswith("plain")
                                           else 2)
        check(counts["flash_attention"] == want and
              routes == {"wgmma": want, "mma": 0},
              f"lm_moe {label}: flash_attention launched "
              f"{counts['flash_attention']} times by route {routes}, not "
              f"{want} on wgmma")
        launches[label] = counts["flash_attention"]
        host = host_params(params)
        del params, opt
        step_ms = tel.summary()["mean_s"] * 1e3
        runs[label] = dict(losses=losses, step_ms=step_ms,
                           tokens_per_s=tokens / step_ms * 1e3,
                           peak_memory_gb=peak_gb, step_times_s=tel.times,
                           launches=counts["flash_attention"])
        if plain is None:
            plain, flash_calls = (losses, host), calls
            check(all(np.isfinite(losses)), f"lm_moe: losses {losses}")
        elif label.startswith("microbatch"):
            diff = abs(losses[0] - plain[0][0])
            halves = microbatch_loss(cfg, run)
            runs[label].update(first_loss_diff=diff, halves_loss=halves)
            check(losses[0] == halves, f"lm_moe: microbatch 2's first loss "
                  f"{losses[0]} is not its halves' {halves}")
            check(diff <= MOE_MB_TOL and all(np.isfinite(losses)),
                  f"lm_moe: microbatch 2's first loss {losses[0]} is "
                  f"{diff:.3e} off the plain run's {plain[0][0]}")
        else:
            same_p = bitwise(host, plain[1])
            runs[label]["bitwise"] = losses == plain[0] and same_p
            check(losses == plain[0] and same_p,
                  f"lm_moe: {label}'s losses {losses} or parameters are not "
                  f"bitwise the plain run's {plain[0]}")
        del host
        log(f"[lm_moe] train {label}: losses {losses}; {step_ms:.2f} ms a step "
            f"(mean of steps 1-{MOE_STEPS - 1}), {tokens / step_ms * 1e3:.4e} "
            f"tokens/s, peak memory {peak_gb:.2f} GB; flash launches "
            f"{launches[label]}"
            + ("" if label == "plain" else
               f"; first loss bitwise (0 + l0 / 2) + l1 / 2 of its halves' "
               f"losses, {runs[label]['first_loss_diff']:.3e} off the plain "
               f"run's" if label.startswith("microbatch") else
               "; losses and parameters bitwise the plain run's"))
    del plain
    (a, _, _), = flash_calls.values()
    q, k, v = (t.detach() for t in a)
    bh, s, dh = q.shape
    check(fa.route(q, k, v) == "wgmma", f"lm_moe: {tuple(q.shape)} not on "
          f"wgmma")
    err = compare("flash_attention", f"qwen3-moe {tuple(q.shape)} wgmma",
                  fa.launch(q, k, v, True), ref.flash_attention(q, k, v),
                  FLASH_BF16_TOL)
    t_k = time_ms(lambda: fa.launch(q, k, v, True), reps=20)
    t_m = time_ms(lambda: fa.launch(q, k, v, True, route="mma"), reps=20)
    t_p = time_ms(lambda: ref.flash_attention(q, k, v), reps=5)
    q4, k4, v4 = (t.view(MOE_BATCH, bh // MOE_BATCH, s, dh) for t in (q, k, v))
    t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), reps=20)
    flops, (bms, by) = flash_bound(q, k, v)
    log(f"[times] flash_attention on qwen3-moe's layers ({bh}, {s}, {dh}) "
        f"bf16 causal: wgmma {t_k:.4f} ms ({flops / t_k / 1e9:.1f} TFLOP/s, "
        f"{bms / t_k:.3f} of the bound), mma {t_m:.4f}, plain {t_p:.4f}, SDPA "
        f"{t_l:.4f}, bound {bms:.4f} ms ({by})")
    total = sum(launches.values())
    report["lm_moe"]["train"] = dict(
        runs=runs, launches=launches, flash_ms=t_k, mma_ms=t_m, plain_ms=t_p,
        library_ms=t_l, bound_ms=bms, bound_by=by, err=err)
    del q, k, v, q4, k4, v4, a, flash_calls
    torch.cuda.empty_cache()
    entry = kernel_entry(
        "lm_moe_train", "flash_attention", "cuda",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:106", total, err, t_k, t_p,
        bms, by, t_l)
    entry.update(variant="wgmma", mma_ms=t_m)
    return entry


def moe_checkpoint(report):
    """qwen3-moe at MOE_CKPT_LAYERS layers, experts and vocabulary cut to
    MOE_CKPT_EXPERTS and MOE_CKPT_VOCAB: MOE_STEPS steps straight through,
    against half of them saved and the rest resumed in a fresh ``train``
    call; the restored state bitwise the saved one, the resumed losses and
    final parameters bitwise the uninterrupted run's."""
    import dataclasses
    import tempfile
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.train import restore_state, train
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_CKPT_LAYERS,
                              n_experts=MOE_CKPT_EXPERTS, vocab=MOE_CKPT_VOCAB)
    run = RunConfig(seq_len=MOE_SEQ, global_batch=MOE_BATCH, warmup=1,
                    flash_kernel=True)
    half = MOE_STEPS // 2
    t0 = time.perf_counter()
    p, _, straight, _ = train(cfg, run, MOE_STEPS, device=DEV, log_every=0)
    want = host_params(p)
    del p
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="moe_ckpt-") as d:
        p1, o1, first, _ = train(cfg, run, half, device=DEV, log_every=0,
                                 checkpoint_dir=d, checkpoint_every=half)
        rp, ro, step = restore_state(cfg, CheckpointStore(d), DEV)
        check(step == half and ro["count"] == o1["count"] and
              bitwise(list(rp.parameters()), list(p1.parameters())) and
              bitwise(ro["mu"], o1["mu"]) and bitwise(ro["nu"], o1["nu"]),
              "lm_moe: the restored parameters or AdamW state are not "
              "bitwise the saved ones")
        del p1, o1, rp, ro
        torch.cuda.empty_cache()
        p2, o2, resumed, _ = train(cfg, run, MOE_STEPS - half, device=DEV,
                                   log_every=0, checkpoint_dir=d,
                                   checkpoint_every=half)
        latest = CheckpointStore(d).latest()
    same_p = bitwise(host_params(p2), want)
    del p2, o2, want
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[lm_moe] checkpoint: {cfg.name} at {cfg.n_layers} layer(s), "
        f"{cfg.n_experts} experts top-{cfg.experts_per_tok}, vocab "
        f"{cfg.vocab}: {MOE_STEPS} steps straight {straight}; {half} saved + "
        f"{MOE_STEPS - half} resumed {first + resumed} (latest step {latest}); "
        f"the restored state bitwise the saved one; losses "
        f"{'bitwise' if first + resumed == straight else 'NOT bitwise'}, "
        f"parameters {'bitwise' if same_p else 'NOT bitwise'}; {secs:.1f} s")
    check(latest == MOE_STEPS and first + resumed == straight and same_p,
          "lm_moe: the resumed run is not bitwise the uninterrupted one")
    report["lm_moe"]["checkpoint"] = dict(
        straight=straight, resumed=first + resumed, bitwise=True,
        layers=cfg.n_layers, experts=cfg.n_experts, vocab=cfg.vocab,
        seconds=secs)


def phase_lm_moe(report):
    """Experts on the card: qwen3-moe serving at full width (depth
    MOE_SERVE_LAYERS), the f32 serving and routing checks of qwen3-moe and
    moonshot at MOE_LAYERS layers, qwen3-moe's training runs (plain, remat
    full and dots, microbatch 2) through the flash kernel, and a resumed
    MoE trainer."""
    report["lm_moe"] = {}
    stage_s = report["lm_moe"]["stage_s"] = {}

    def timed(key, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        stage_s[key] = time.perf_counter() - t0
        return out
    torch.cuda.empty_cache()
    timed(f"{MOE_ARCH} serve", moe_serve, report)
    for name in MOE_CHECK_ARCHS:
        timed(f"{name} checks", moe_checks, report, name)
    entry = timed("train", moe_train, report)
    timed("checkpoint", moe_checkpoint, report)
    log(f"[lm_moe] seconds by stage: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in stage_s.items())}")
    return [entry]


# ---------------------------------------------------------------------------
# recurrent layers: recurrentgemma-2b (RG-LRU + local attention) and
# mamba2-370m (SSD) serving and training
# ---------------------------------------------------------------------------

def recurrent_layer_times(name, cfg, params):
    """The first recurrent layer of the served model alone, at
    SERVE_PROMPT tokens of batch 8 in bf16 compute, as prefill runs it
    (plain torch, no kernel of the port): the whole layer and, for the
    RG-LRU, its scan over f32 (a, b) pairs; ms by CUDA events, device busy
    ms and launches under the profiler."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import layers as L
    run = RunConfig()
    block = next(b for b in params.blocks if b.kind in ("rglru", "ssd"))
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x = torch.randn((8, SERVE_PROMPT, cfg.d_model), generator=gen,
                    device=DEV).to(L._dtype(run))
    out = {}
    with torch.inference_mode():
        h = L.apply_norm(block.norm1, x, cfg)
        if block.kind == "rglru":
            p = block.rglru
            _, _, xf, r, i = L._rglru_inputs(p, h, run)
            fns = {"rglru layer": lambda: L.rglru_train(p, h, cfg, run),
                   "rglru scan": lambda: L._rglru_core(xf, r, i, p["lam"])}
        else:
            fns = {"ssd layer": lambda: L.ssd_train(block.ssd, h, cfg, run)}
        for key, fn in fns.items():
            ms = time_ms(fn, reps=5)
            trace = profile_steps(fn, 1, label=f"lm_recurrent {name} {key}")
            launches = sum(k["calls_per_step"] for k in trace["kernels"])
            out[key] = dict(ms=ms, busy_ms=trace["busy_ms"], launches=launches)
            log(f"[lm_recurrent] {name}: {key} at 8 x {SERVE_PROMPT} bf16: "
                f"{ms:.3f} ms (CUDA events), device busy {trace['busy_ms']:.3f}"
                f" ms in {launches} launches")
    return out


def recurrent_serve(report, name, batch):
    """``name`` at full width and depth through ``serve``
    (:func:`serve_perf`: prefill first and warm, decode ms a step,
    tokens/s, the decode profile with its launches a step, peak memory, a
    decode step twice bitwise), then its recurrent layer alone
    (:func:`recurrent_layer_times`)."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models import make_model
    cfg = get_arch(name)
    params = make_model(cfg)["init"](RunConfig(), device=DEV)
    log(f"[lm_recurrent] {name}: {cfg.n_layers} layers "
        f"{''.join(k[0].upper() for k in cfg.layer_kinds())}, d_model "
        f"{cfg.d_model}, inner width {cfg.d_inner}, ssm heads "
        f"{cfg.ssm_heads if 'ssd' in cfg.pattern else 0}, state "
        f"{cfg.ssm_state}, window {cfg.window}, vocab {cfg.vocab}; "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}B f32 "
        f"parameters")
    out = serve_perf(name, batch, params, cfg, tag="lm_recurrent")
    out["decode_launches_per_step"] = sum(
        k["calls_per_step"] for k in out["decode_trace"]["kernels"])
    log(f"[lm_recurrent] {name}: {out['decode_launches_per_step']} kernel "
        f"launches a decode step")
    out["layer_times"] = recurrent_layer_times(name, cfg, params)
    del params
    torch.cuda.empty_cache()
    report["lm_recurrent"][name] = out


def long_memory(params):
    """Every RG-LRU layer's ``lam`` and every SSD layer's ``dt_bias`` set
    to RECUR_LONG_MEMORY's values, in place."""
    with torch.no_grad():
        for b in params.blocks:
            if b.kind == "rglru":
                b.rglru["lam"].fill_(RECUR_LONG_MEMORY["lam"])
            elif b.kind == "ssd":
                b.ssd["dt_bias"].fill_(RECUR_LONG_MEMORY["dt_bias"])


def recurrent_checks(report, name):
    """``name`` at full width, RECUR_CHECK_LAYERS layers, f32, batch 2,
    at the initialisation's weights and then at the long-memory edit: a
    prefill of RECUR_PROMPT tokens twice bitwise (logits and caches); a
    decode step twice from one cache bitwise; RECUR_DECODE teacher-forced
    decode steps, each step's logits against the position's logits of one
    training forward (``transformer.forward``) over all the tokens, within
    DECODE_TOL; the controls: the first decode step from a copy of the
    cache with the first recurrent layer's ``h``, and separately its
    ``conv``, zeroed, which must leave the tolerance at long memory."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.data import TokenStream
    from repro_torch.models import make_model
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch(name),
                              n_layers=RECUR_CHECK_LAYERS[name])
    s0, k = RECUR_PROMPT, RECUR_DECODE
    run = RunConfig(seq_len=s0 + k, global_batch=2, dtype="float32",
                    attn_chunk=RECUR_CHUNK)
    model = make_model(cfg)
    params = model["init"](run, device=DEV)
    seq = torch.from_numpy(TokenStream(vocab=cfg.vocab, seq_len=s0 + k,
                                       batch=2, seed=SEED + 3)
                           .batch_at(0)["tokens"]).to(DEV, torch.int64)
    kinds = cfg.layer_kinds()
    first = next(i for i, kind in enumerate(kinds) if kind in ("rglru", "ssd"))
    out = {"layers": cfg.n_layers, "kinds": kinds}
    for setting in ("default", "long memory"):
        if setting == "long memory":
            long_memory(params)
        with torch.inference_mode():
            full = T.forward(params, seq, cfg, run)
            with attention_routes() as routes:
                l1, cache = model["prefill"](params, {"tokens": seq[:, :s0]},
                                             run, s0 + k)
            l2, again = model["prefill"](params, {"tokens": seq[:, :s0]},
                                         run, s0 + k)
            check(routes["window"] == kinds.count("local") and
                  routes["flash_skip"] == 0, f"{name}: the {s0}-token "
                  f"prefill took routes {routes}")
            check(torch.equal(l1, l2) and all(
                torch.equal(a[n], b[n]) for a, b in zip(cache, again)
                for n in a), f"{name} ({setting}): a prefill twice differs")
            controls = {}
            for part in ("h", "conv"):
                faulty = [{n: t.clone() for n, t in c.items()} for c in cache]
                faulty[first][part].zero_()
                ctl, _ = model["decode_step"](params, faulty,
                                              seq[:, s0:s0 + 1], s0, run)
                controls[part] = _tol_units(ctl, full[:, s0], cfg.vocab)
                del faulty
            twice, _ = model["decode_step"](params, again, seq[:, s0:s0 + 1],
                                            s0, run)
            worst = 0.0
            for i in range(k):
                pos = s0 + i
                dec, _ = model["decode_step"](params, cache,
                                              seq[:, pos:pos + 1], pos, run)
                if i == 0:
                    check(torch.equal(dec, twice) and all(
                        torch.equal(a[n], b[n]) for a, b in zip(cache, again)
                        for n in a), f"{name} ({setting}): a decode step "
                          f"twice from one cache differs")
                worst = max(worst, _tol_units(dec, full[:, pos], cfg.vocab))
            del full, cache, again
        log(f"[lm_recurrent] {name} at {cfg.n_layers} layers "
            f"({''.join(c[0].upper() for c in kinds)}), f32, {setting} "
            f"weights: a prefill of 2 x {s0} tokens (routes {routes}) and "
            f"a decode step each twice bitwise; {k} teacher-forced decode "
            f"steps against one training forward over {s0 + k} tokens: "
            f"worst |diff| {worst:.3e} of atol + rtol |ref| (rtol = atol = "
            f"2e-3); the first step with layer {first}'s h zeroed "
            f"{controls['h']:.3e} of it, its conv zeroed "
            f"{controls['conv']:.3e}")
        check(worst <= 1.0, f"{name} ({setting}): decode differs from the "
              f"training forward by {worst:.3e} of the tolerance")
        if setting == "long memory":
            check(min(controls.values()) > 1.0, f"{name}: a zeroed state "
                  f"moves the first decode step by only {controls} of the "
                  f"tolerance at long memory")
        out[setting] = dict(teacher_forced_worst=worst, controls=controls)
    del params
    torch.cuda.empty_cache()
    report["lm_recurrent"][f"{name} checks"] = out


def recurrent_grads_finite(cfg, run):
    """Step 0's loss and gradient at the port's initialisation from
    ``run.seed``, on the trainer's first batch: ``(loss, global norm,
    the names of the leaves with a non-finite entry)``."""
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import batch_to
    from repro_torch.models import make_model
    model = make_model(cfg)
    params = model["init"](run, device=DEV)
    batch = batch_to(TokenStream(vocab=cfg.vocab, seq_len=run.seq_len,
                                 batch=run.global_batch, seed=run.seed)
                     .batch_at(0), DEV)
    loss = model["train_loss"](params, batch, run)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    bad = [n for n, g in zip(names, grads) if not torch.isfinite(g).all()]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads])).item()
    loss = float(loss.detach())
    del params, grads
    torch.cuda.empty_cache()
    return loss, norm, bad


def recurrent_train(report):
    """Each of RECUR_TRAIN at full width and its depth, batch RECUR_BATCH x
    RECUR_SEQ, bf16 compute, through ``train`` (RECUR_STEPS steps from the
    port's initialisation): step 0's loss and every gradient finite
    (:func:`recurrent_grads_finite`), every loss finite, the remat run
    bitwise the plain run (losses and parameters), ms a step, tokens/s and
    peak memory."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.train import train
    tokens = RECUR_BATCH * RECUR_SEQ
    out = {}
    for name, layers, variants in RECUR_TRAIN:
        cfg = dataclasses.replace(get_arch(name), n_layers=layers)
        base = RunConfig(seq_len=RECUR_SEQ, global_batch=RECUR_BATCH,
                         warmup=1)
        torch.cuda.empty_cache()
        loss0, gnorm, bad = recurrent_grads_finite(cfg, base)
        log(f"[lm_recurrent] train {name} at {layers} layers: step 0's loss "
            f"{loss0:.6f}, gradient norm {gnorm:.4e}, non-finite leaves "
            f"{bad}")
        check(np.isfinite(loss0) and np.isfinite(gnorm) and not bad,
              f"{name}: step 0's loss {loss0} or gradient is not finite "
              f"({bad})")
        runs, plain = {}, None
        for label in variants:
            run = dataclasses.replace(base, remat="full") \
                if label == "remat full" else base
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params, opt, losses, tel = train(cfg, run, RECUR_STEPS,
                                             device=DEV, log_every=0)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            del opt
            host = host_params(params)
            del params
            torch.cuda.empty_cache()
            summ = tel.summary()
            step_ms, p50_ms = summ["mean_s"] * 1e3, summ["p50_s"] * 1e3
            spread = [t * 1e3 for t in tel.times[1:]]
            check(all(np.isfinite(losses)) and
                  all(torch.isfinite(p).all() for p in host),
                  f"{name} {label}: losses {losses} or parameters not finite")
            runs[label] = dict(losses=losses, step_ms=step_ms,
                               step_p50_ms=p50_ms,
                               tokens_per_s=tokens / step_ms * 1e3,
                               peak_memory_gb=peak_gb, step_times_s=tel.times)
            if plain is None:
                plain = (losses, host)
            else:
                same = losses == plain[0] and bitwise(host, plain[1])
                runs[label]["bitwise"] = same
                check(same, f"{name}: {label}'s losses {losses} or "
                      f"parameters are not bitwise the plain run's "
                      f"{plain[0]}")
            del host
            log(f"[lm_recurrent] train {name} {label} ({layers} layers, "
                f"{RECUR_BATCH} x {RECUR_SEQ}): losses {losses}; "
                f"{step_ms:.2f} ms a step (mean of steps 1-"
                f"{RECUR_STEPS - 1}; median {p50_ms:.2f}, least "
                f"{min(spread):.2f}, most {max(spread):.2f}), "
                f"{tokens / step_ms * 1e3:.4e} tokens/s, "
                f"peak memory {peak_gb:.2f} GB"
                + ("; losses and parameters bitwise the plain run's"
                   if label != "plain" else ""))
        del plain
        out[name] = dict(layers=layers, loss0=loss0, grad_norm=gnorm,
                         runs=runs)
    report["lm_recurrent"]["train"] = out


def phase_lm_recurrent(report):
    """Recurrent layers on the card: recurrentgemma-2b and mamba2-370m at
    full width and depth through ``serve``, their f32 decode checks at
    reduced depth with their controls, and their training steps.  No
    kernel of the port is on this path; the ``kernels`` line gains no
    entry."""
    from repro_torch.kernels import ops
    report["lm_recurrent"] = {}
    stage_s = report["lm_recurrent"]["stage_s"] = {}

    def timed(key, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        stage_s[key] = time.perf_counter() - t0
        return out
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    for name, batch in RECUR_SERVE:
        timed(f"{name} serve", recurrent_serve, report, name, batch)
    for name, _ in RECUR_SERVE:
        timed(f"{name} checks", recurrent_checks, report, name)
    timed("train", recurrent_train, report)
    counts = ops.launch_counts()
    check(sum(counts.values()) == 0, f"lm_recurrent launched {counts}: its "
          f"path reaches no kernel")
    log(f"[lm_recurrent] kernel launches over the phase {counts}; seconds "
        f"by stage: {', '.join(f'{k} {v:.1f}' for k, v in stage_s.items())}")
    return []


# ---------------------------------------------------------------------------
# the encoder and the modality frontends: whisper-large-v3 and internvl2-1b
# ---------------------------------------------------------------------------

def clone_cache(cache):
    """A copy of a decode cache, a layer's ``"cross"`` entries too."""
    return [{n: ({m: u.clone() for m, u in t.items()} if isinstance(t, dict)
                 else t.clone()) for n, t in c.items()} for c in cache]


def caches_equal(a, b):
    """Bitwise equality of two decode caches, ``"cross"`` entries too."""
    def flat(cache):
        return [u for c in cache for t in c.values()
                for u in (t.values() if isinstance(t, dict) else (t,))]
    return bitwise(flat(a), flat(b))


def encoder_batch(cfg, batch, text, seed, tokens=None):
    """A numpy batch of ``cfg``'s model: ``tokens`` (or ``text`` tokens and
    their labels from TokenStream), and the stub's frames (ENC_FRAMES) or
    patches (``cfg.n_patches``) as normal draws from ``seed``."""
    from repro_torch.data import TokenStream
    out = TokenStream(vocab=cfg.vocab, seq_len=text, batch=batch,
                      seed=seed).batch_at(0) if tokens is None else \
        {"tokens": tokens}
    n, key = (ENC_FRAMES, "frames") if cfg.family == "encdec" else \
        (cfg.n_patches, "patches")
    out[key] = np.random.default_rng(seed).normal(
        size=(batch, n, cfg.d_model)).astype(np.float32)
    return out


def encoder_serve(report, name):
    """``name`` at full width and depth through ``build_prefill_step`` and
    ``build_decode_step`` (``serve`` takes tokens only), bf16 compute,
    ENC_SERVE_BATCH streams: whisper's ENC_FRAMES frames and its 4-token
    start-of-transcript prompt, internvl2's 256 patches and ENC_VLM_TEXT
    tokens; ENC_NEW greedy tokens.  Prefill first and warm (whisper's
    encoder alone too), decode ms a step and tokens/s, a decode step twice
    from one cache bitwise, ENC_PROFILE_STEPS decode steps under the
    profiler with their launches a step, peak memory; no kernel
    launched."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (batch_to, build_decode_step,
                                          build_prefill_step)
    from repro_torch.models import make_model
    from repro_torch.models import transformer as T
    cfg = get_arch(name)
    b = ENC_SERVE_BATCH
    if cfg.family == "encdec":
        text, prefix = len(ENC_SOT), 0
        nb = encoder_batch(cfg, b, text, SEED, tokens=np.tile(
            np.asarray(ENC_SOT, np.int32), (b, 1)))
    else:
        text, prefix = ENC_VLM_TEXT, cfg.n_patches
        nb = encoder_batch(cfg, b, text, SEED)
        del nb["labels"]
    run = RunConfig(seq_len=text, global_batch=b)
    torch.cuda.empty_cache()
    params = make_model(cfg)["init"](run, device=DEV)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[lm_encoder] {name}: {cfg.n_enc_layers} encoder + {cfg.n_layers} "
        f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} kv heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, "
        f"{cfg.norm}, {cfg.act}, vocab {cfg.vocab}; {n_params / 1e9:.4f}B f32 "
        f"parameters ({n_params * 4 / 1e9:.2f} GB)")
    prefill = build_prefill_step(cfg, run, DEV)["fn"]
    decode = build_decode_step(cfg, run, DEV)["fn"]
    cache_len = prefix + text + ENC_NEW
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = {"batch": b, "prefix": prefix, "prompt_len": text,
           "new_tokens": ENC_NEW, "params": n_params}
    with torch.inference_mode(), attention_routes() as routes:
        batch = batch_to(nb, DEV)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, batch, cache_len)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out.update(prefill_ms=times[0], prefill_warm_ms=times[1])
        if cfg.family == "encdec":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = T._encode(params, batch["frames"], cfg, run)
            torch.cuda.synchronize()
            out["encoder_ms"] = (time.perf_counter() - t0) * 1e3
            check(tuple(enc.shape) == (b, ENC_FRAMES, cfg.d_model) and
                  bool(torch.isfinite(enc).all()), f"{name}: the encoder's "
                  f"output {tuple(enc.shape)} is not finite")
            del enc
            cross = cache[0]["cross"]["k"].shape
            check(tuple(cross) == (b, cfg.n_kv_heads, ENC_FRAMES,
                                   cfg.head_dim_), f"{name}: cross cache "
                  f"{tuple(cross)}")
        tok = torch.argmax(logits, -1)[:, None]
        # a decode step twice from one cache, at the first new position
        twins = [clone_cache(cache), clone_cache(cache)]
        outs = [decode(params, c, tok, prefix + text)[0] for c in twins]
        check(torch.equal(*outs) and caches_equal(*twins),
              f"{name}: a decode step twice from one cache differs")
        del twins, outs
        gen = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ENC_NEW):
            gen.append(tok[:, 0])
            logits, cache = decode(params, cache, tok, prefix + text + i)
            tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        toks = torch.stack(gen, 1).cpu().numpy()
        check(toks.shape == (b, ENC_NEW) and (toks >= 0).all() and
              (toks < cfg.vocab).all() and bool(torch.isfinite(
                  logits[:, :cfg.vocab]).all()), f"{name}: generated tokens "
              f"{toks.shape} outside [0, {cfg.vocab}) or logits not finite")
        out.update(decode_ms=decode_s / ENC_NEW * 1e3,
                   tokens_per_s=b * ENC_NEW / decode_s,
                   continuation=toks[0].tolist())
        # the last ENC_PROFILE_STEPS positions again, warm, then profiled
        start = cache_len - ENC_PROFILE_STEPS
        state = {"tok": tok}

        def decode_steps():
            for pos in range(start, cache_len):
                lg, _ = decode(params, cache, state["tok"], pos)
                state["tok"] = torch.argmax(lg, -1)[:, None]
        decode_steps()
        trace = profile_steps(decode_steps, ENC_PROFILE_STEPS,
                              label=f"lm_encoder {name} decode trace")
        del cache, batch
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # two prefills: a prompt of more than two chunks, a multiple of the
    # chunk (internvl2's 4,096 positions), takes the chunked route with the
    # causal skip, whisper's 4 tokens the dense one
    s = prefix + text
    chunked = s > 2 * run.attn_chunk and s % run.attn_chunk == 0
    want = {"flash": 0, "flash_skip": 2 * cfg.n_layers if chunked else 0,
            "window": 0}
    check(routes == want, f"{name}: prefill took routes {routes}, not {want}")
    check(sum(counts.values()) == 0, f"{name}: serving launched {counts}: "
          f"its path reaches no kernel")
    launches = sum(k["calls_per_step"] for k in trace["kernels"])
    idle = 1 - trace["busy_ms"] / trace["step_ms"] if trace["kernels"] \
        else "not measured"
    out.update(decode_trace=trace, decode_idle_share=idle,
               decode_launches_per_step=launches, peak_memory_gb=peak_gb,
               routes=routes)
    log(f"[lm_encoder] {name}: {b} x ({prefix} + {text}) prompt, {ENC_NEW} "
        f"new tokens, bf16: prefill {out['prefill_ms']:.2f} ms, warm "
        f"{out['prefill_warm_ms']:.2f} ms"
        + (f" (the encoder alone {out['encoder_ms']:.2f} ms)"
           if "encoder_ms" in out else "")
        + f"; decode {out['decode_ms']:.3f} ms a step, "
        f"{out['tokens_per_s']:.1f} tokens/s; {ENC_PROFILE_STEPS} steps "
        f"profiled: {trace['step_ms']:.3f} ms a step, busy "
        f"{trace['busy_ms']:.3f} ms, idle share "
        f"{idle if isinstance(idle, str) else f'{idle:.3f}'}, {launches} "
        f"launches a step; peak memory {peak_gb:.2f} GB; a decode step twice "
        f"bitwise; prefill routes {routes}, launches {counts}; continuation "
        f"of stream 0: {toks[0, :8].tolist()}")
    del params
    torch.cuda.empty_cache()
    report["lm_encoder"][name] = out


def encoder_checks(report, name):
    """``name`` at full width and ENC_CHECK_LAYERS depth in f32, batch 2:
    the prefill's last logits against the training forward's
    (``transformer.forward``) at that position, the check of the
    reference's defect on the card's own path; ENC_CHECK_STEPS
    teacher-forced decode steps against that forward within DECODE_TOL;
    the controls, each of which must leave it: the first decode step with
    one layer's cross K zeroed (whisper), with the last prompt position's
    key and value zeroed in every layer, and the prefill's logits with the
    frames or patches zeroed."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.steps import batch_to
    from repro_torch.models import make_model
    from repro_torch.models import transformer as T
    enc_layers, layers = ENC_CHECK_LAYERS[name]
    cfg = dataclasses.replace(get_arch(name), n_layers=layers,
                              n_enc_layers=enc_layers)
    k = ENC_CHECK_STEPS
    if cfg.family == "encdec":
        prefix, s0, key = 0, len(ENC_SOT), "frames"
    else:
        prefix, s0, key = cfg.n_patches, ENC_CHECK_VLM_PROMPT, "patches"
    run = RunConfig(seq_len=s0 + k, global_batch=2, dtype="float32",
                    attn_chunk=ENC_CHECK_CHUNK)
    model = make_model(cfg)
    params = model["init"](run, device=DEV)
    nb = encoder_batch(cfg, 2, s0 + k, SEED + 5)
    if cfg.family == "encdec":
        nb["tokens"][:, :s0] = ENC_SOT
    batch = batch_to(nb, DEV)
    seq = batch["tokens"]
    prompt = {"tokens": seq[:, :s0], key: batch[key]}
    out = {"layers": layers, "enc_layers": enc_layers, "prompt": s0,
           "prefix": prefix}
    with torch.inference_mode():
        full = T.forward(params, seq, cfg, run, **{key: batch[key]})
        with attention_routes() as routes:
            l0, cache = model["prefill"](params, prompt, run,
                                         prefix + s0 + k)
        s = prefix + s0
        want_routes = cfg.n_layers if s > 2 * run.attn_chunk and \
            s % run.attn_chunk == 0 else 0
        check(routes["flash_skip"] == want_routes, f"{name}: the "
              f"{prefix + s0}-position prefill took routes {routes}")
        prefill_err = _tol_units(l0, full[:, s0 - 1], cfg.vocab)
        zeroed, _ = model["prefill"](params, dict(prompt, **{
            key: torch.zeros_like(batch[key])}), run, prefix + s0 + k)
        ctl = {"inputs zeroed": _tol_units(zeroed, l0, cfg.vocab)}
        faulty = clone_cache(cache)
        for layer in faulty:
            layer["k"][:, :, prefix + s0 - 1] = 0
            layer["v"][:, :, prefix + s0 - 1] = 0
        first = full[:, s0]
        tok0 = seq[:, s0:s0 + 1]
        ctl["one key zeroed"] = _tol_units(model["decode_step"](
            params, faulty, tok0, prefix + s0, run)[0], first, cfg.vocab)
        if cfg.family == "encdec":
            faulty = clone_cache(cache)
            faulty[0]["cross"]["k"].zero_()
            ctl["cross k zeroed"] = _tol_units(model["decode_step"](
                params, faulty, tok0, prefix + s0, run)[0], first, cfg.vocab)
        del faulty, zeroed
        worst = 0.0
        for i in range(k):
            pos = s0 + i
            dec, _ = model["decode_step"](params, cache, seq[:, pos:pos + 1],
                                          prefix + pos, run)
            worst = max(worst, _tol_units(dec, full[:, pos], cfg.vocab))
        del full, cache
    out.update(prefill_vs_forward=prefill_err, teacher_forced_worst=worst,
               controls=ctl, routes=routes)
    log(f"[lm_encoder] {name} at {enc_layers} + {layers} layers, f32, batch "
        f"2: prefill of {prefix} + {s0} positions ({routes}) against the "
        f"training forward at its last position {prefill_err:.3e} of atol + "
        f"rtol |ref| (rtol = atol = 2e-3); {k} teacher-forced decode steps "
        f"against the training forward: worst {worst:.3e} of it; controls "
        + ", ".join(f"{c} {v:.3e}" for c, v in ctl.items()))
    check(prefill_err <= 1.0, f"{name}: prefill is {prefill_err:.3e} of the "
          f"tolerance off the training forward")
    check(worst <= 1.0, f"{name}: decode differs from the training forward "
          f"by {worst:.3e} of the tolerance")
    check(min(ctl.values()) > 1.0, f"{name}: a control stays within the "
          f"tolerance: {ctl}")
    del params
    torch.cuda.empty_cache()
    report["lm_encoder"][f"{name} checks"] = out


def encoder_train(report, name, batch, text):
    """``name`` at full width and depth through ``build_train_step`` with
    the flash kernel (``train`` takes tokens only), bf16 compute, f32
    parameters and AdamW from the port's seeded initialisation,
    ENC_TRAIN_STEPS steps at ``batch`` x ``text`` tokens and the stub's
    frames or patches, launch counts set to 0 just before and read just
    after: the decoder's causal self-attention through the kernel once a
    layer a forward, all on the wgmma route (Dh 64); step 0's loss against
    the chance level of the initial logits on its batch, every loss and
    gradient norm finite; ms a step (median of steps 1-7), tokens/s, peak
    memory; the kernel at the inputs the path handed it against its plain
    version, timed beside the mma route, its bound and SDPA (a yardstick
    the port never calls)."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import batch_to, build_train_step
    from repro_torch.models import make_model
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = get_arch(name)
    run = RunConfig(seq_len=text, global_batch=batch, warmup=1,
                    flash_kernel=True)
    batches = [encoder_batch(cfg, batch, text, SEED + 20 + i)
               for i in range(ENC_TRAIN_STEPS)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = make_model(cfg)["init"](run, device=DEV)
    key = T.modality_inputs(cfg)[0]
    with torch.no_grad():
        b0 = batch_to(batches[0], DEV)
        z = T.forward(params, b0["tokens"], cfg, run,
                      **{key: b0[key]})[..., :cfg.vocab]
        chance = float((torch.logsumexp(z, -1) - z.mean(-1)).mean())
        del z, b0
    opt = adamw_init(list(params.parameters()))
    step = build_train_step(cfg, run, DEV)["fn"]
    losses, gnorms, times = [], [], []
    ops.reset_launch_counts()
    with recording("flash_attention") as calls:
        for i, nb in enumerate(batches):
            tb = batch_to(nb, DEV)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, tb, i)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
            times.append(time.perf_counter() - t0)
    counts, routes = ops.launch_counts(), ops.route_counts()["flash_attention"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params, opt
    torch.cuda.empty_cache()
    want = cfg.n_layers * ENC_TRAIN_STEPS
    check(counts["flash_attention"] == want and
          routes == {"wgmma": want, "mma": 0},
          f"{name}: flash_attention launched {counts['flash_attention']} "
          f"times by route {routes}, not {want} on wgmma")
    n_tok = batch * text
    ln_v = float(np.log(cfg.vocab))
    tol = 5 / np.sqrt(n_tok)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{name}: losses {losses} or gradient norms {gnorms} not finite")
    check(abs(losses[0] - chance) <= tol and abs(chance - ln_v) <= 1.0,
          f"{name}: step 0's loss {losses[0]} is not the chance level "
          f"{chance} of its logits within {tol:.3f}, or that is not near "
          f"ln V = {ln_v}")
    steady = [t * 1e3 for t in times[1:]]
    med = float(np.median(steady))
    positions = batch * (text + (ENC_FRAMES if cfg.family == "encdec"
                                 else cfg.n_patches))
    (a, _, _), = calls.values()
    q, k, v = (t.detach() for t in a)
    bh, s, dh = q.shape
    check(fa.route(q, k, v) == "wgmma", f"{name}: {tuple(q.shape)} not on "
          f"wgmma")
    err = compare("flash_attention", f"{name} {tuple(q.shape)} wgmma",
                  fa.launch(q, k, v, True), ref.flash_attention(q, k, v),
                  FLASH_BF16_TOL)
    t_k = time_ms(lambda: fa.launch(q, k, v, True), reps=20)
    t_m = time_ms(lambda: fa.launch(q, k, v, True, route="mma"), reps=20)
    t_p = time_ms(lambda: ref.flash_attention(q, k, v), reps=5)
    q4, k4, v4 = (t.view(batch, bh // batch, s, dh) for t in (q, k, v))
    t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), reps=20)
    flops, (bms, by) = flash_bound(q, k, v)
    out = dict(batch=batch, text=text, losses=losses, grad_norms=gnorms,
               chance_level=chance, ln_v=ln_v, step_times_s=times,
               step_median_ms=med, step_mean_ms=float(np.mean(steady)),
               tokens_per_s=n_tok / med * 1e3,
               positions_per_s=positions / med * 1e3, peak_memory_gb=peak_gb,
               launches=counts["flash_attention"], routes=routes,
               flash_shape=[bh, s, dh], flash_ms=t_k, mma_ms=t_m,
               plain_ms=t_p, library_ms=t_l, bound_ms=bms, bound_by=by,
               err=err)
    log(f"[lm_encoder] train {name}: {batch} x {text} tokens"
        + (f" + {ENC_FRAMES} frames" if cfg.family == "encdec" else
           f" after {cfg.n_patches} patches")
        + f", {cfg.n_enc_layers} + {cfg.n_layers} layers, flash kernel: "
        f"losses {losses}; step 0 {losses[0]:.4f} against the chance level "
        f"{chance:.4f} of its logits (tol {tol:.3f}; ln V {ln_v:.4f}); "
        f"gradient norms finite; {med:.2f} ms a step (median of steps 1-"
        f"{ENC_TRAIN_STEPS - 1}; mean {out['step_mean_ms']:.2f}, least "
        f"{min(steady):.2f}, most {max(steady):.2f}), "
        f"{out['tokens_per_s']:.4e} tokens/s ({out['positions_per_s']:.4e} "
        f"positions/s), peak memory {peak_gb:.2f} GB; flash launches "
        f"{counts['flash_attention']} {routes}")
    log(f"[times] flash_attention on {name}'s decoder ({bh}, {s}, {dh}) bf16 "
        f"causal: wgmma {t_k:.4f} ms ({flops / t_k / 1e9:.1f} TFLOP/s, "
        f"{bms / t_k:.3f} of the bound), mma {t_m:.4f}, plain {t_p:.4f}, SDPA "
        f"{t_l:.4f}, bound {bms:.4f} ms ({by})")
    report["lm_encoder"][f"{name} train"] = out
    del q, k, v, q4, k4, v4, a, calls
    torch.cuda.empty_cache()
    entry = kernel_entry(
        "lm_whisper_train" if cfg.family == "encdec" else "lm_internvl_train",
        "flash_attention", "cuda",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:106", counts["flash_attention"],
        err, t_k, t_p, bms, by, t_l)
    entry.update(variant="wgmma", mma_ms=t_m)
    return entry


def phase_lm_encoder(report):
    """The encoder and the modality frontends on the card: whisper-large-v3
    and internvl2-1b at full width and depth serving, their f32 decode
    checks at reduced depth with their controls, and their training steps
    through the flash kernel (entries ``lm_whisper_train`` and
    ``lm_internvl_train``)."""
    report["lm_encoder"] = {}
    stage_s = report["lm_encoder"]["stage_s"] = {}

    def timed(key, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        stage_s[key] = time.perf_counter() - t0
        return out
    for name in (ENC_WHISPER, ENC_VLM):
        timed(f"{name} serve", encoder_serve, report, name)
    for name in (ENC_WHISPER, ENC_VLM):
        timed(f"{name} checks", encoder_checks, report, name)
    entries = [timed(f"{name} train", encoder_train, report, name, batch,
                     text) for name, batch, text in ENC_TRAIN]
    log(f"[lm_encoder] seconds by stage: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in stage_s.items())}")
    return entries


# ---------------------------------------------------------------------------
# LM sharding: a (data, model) mesh of virtual shards on the card
# ---------------------------------------------------------------------------

# olmo-1b at full width and depth on (2 data x 2 model) with FSDP, lm_train's
# batch and settings, against lm_train's one-device losses
SHARD_MESH, SHARD_STEPS = (2, 2), 3
# the elastic re-mesh: olmo-1b at 2 of 16 layers, a checkpoint after 2 steps
# on (2, 2) resumed on factor_mesh(2, want_model=2) = (1, 2) and on one device
SHARD_CKPT_LAYERS, SHARD_CKPT_STEPS = 2, 2
# experts: qwen3-moe at lm_moe's training settings (MOE_LAYERS of 48 layers,
# full width, 128 experts) on (1, 2), 64 experts a shard, against lm_moe's
# one-device losses
SHARD_MOE_MESH, SHARD_MOE_STEPS = (1, 2), 2
# two gloo processes on the one card, each running one shard of (1, 2):
# olmo-1b at full width and 2 layers, bitwise one process running both
SHARD_MP_MESH, SHARD_MP_LAYERS, SHARD_MP_STEPS = (1, 2), 2, 2
# serving on a mesh: olmo-1b at full width and depth, f32 (greedy tokens
# compared exactly), prompts of SHARD_SERVE_PROMPT tokens, SHARD_SERVE_NEW
# new ones: 8 streams on (1, 2) (the cache's heads over model) and one on
# (2, 1) (its sequence over data)
SHARD_SERVE_CASES = ((8, (1, 2)), (1, (2, 1)))
SHARD_SERVE_PROMPT, SHARD_SERVE_NEW = 512, 32
# serving whisper-large-v3 and internvl2-1b on a mesh: full width and depth,
# f32, through build_prefill_step/build_decode_step(mesh=), whisper's
# ENC_FRAMES frames and ENC_SOT prompt, internvl2's 256 patches and
# SHARD_MODAL_TEXT tokens, SHARD_MODAL_NEW greedy tokens; (arch, batch,
# mesh): whisper 4 on (2, 2) (its 20 KV heads over model) and 1 on (2, 1)
# (the rows cannot split the batch: each runs the whole encoder),
# internvl2 4 on (1, 4) (its 2 KV heads leave the sequence over model) and
# on (2, 2) (the heads over model)
SHARD_MODAL_CASES = ((ENC_WHISPER, 4, (2, 2)), (ENC_WHISPER, 1, (2, 1)),
                     (ENC_VLM, 4, (1, 4)), (ENC_VLM, 4, (2, 2)))
SHARD_MODAL_TEXT, SHARD_MODAL_NEW = 512, 16
# a zeroed-input prefill must move the logits by more than this many times
# the largest gap between the mesh and one device
SHARD_MODAL_POWER = 100

SHARD_MP_CHILD = """
import sys
sys.path.insert(0, {src!r})
import dataclasses, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
sys.path.insert(0, {root!r})
import chip_smoke
from repro_torch.launch.dist import init_distributed
init_distributed("127.0.0.1:{port}", 2, {rank})
out = chip_smoke.shard_mp_run()
print("RESULT", out["digest"], out["wire"], out["seconds"], out["step_ms"],
      flush=True)
print("DONE", flush=True)
"""


def shard_digest(layout, params, losses):
    """sha256 of every leaf gathered whole from the shards and the losses:
    two runs give one digest only if they give the same bits."""
    from repro_torch.models.parallel import gather_leaves
    h = hashlib.sha256(np.asarray(losses, np.float64).tobytes())
    for t in gather_leaves(layout, params.shards):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def shard_mp_run():
    """olmo-1b at SHARD_MP_LAYERS layers on a (1, 2) mesh over the current
    process group (two gloo ranks, or this process alone): SHARD_MP_STEPS
    steps; the digest, the group's wire bytes and seconds, ms a step."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import train
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=SHARD_MP_LAYERS)
    run = RunConfig(seq_len=LM_SEQ, global_batch=LM_BATCH, flash_kernel=True)
    mesh = Mesh(SHARD_MP_MESH, ("data", "model"))
    params, _, losses, tel = train(cfg, run, SHARD_MP_STEPS, device=DEV,
                                   mesh=mesh, log_every=0)
    torch.cuda.synchronize()
    g = mesh.group
    return dict(digest=shard_digest(params.layout, params, losses),
                losses=losses, wire=sum(g.wire.values()), seconds=g.seconds,
                calls=g.calls, payload=g.payload_bytes,
                step_ms=tel.summary()["mean_s"] * 1e3)


def shard_olmo(report, one):
    """olmo-1b at full width and depth on SHARD_MESH with FSDP through
    ``train(mesh=)``: SHARD_STEPS steps from the seed's initialisation over
    lm_train's batches, each loss within LM_LOSS_TOL of lm_train's
    one-device loss; flash launched once a layer, shard and step; ms a step
    beside lm_train's, the group's payload a step by key, peak memory; the
    kernel at the shard's shape (the inputs the run handed it) against its
    plain version, timed beside its bound, the mma route and SDPA."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import train
    cfg = get_arch(LM_ARCH)
    run = RunConfig(seq_len=LM_SEQ, global_batch=LM_BATCH, flash_kernel=True,
                    fsdp=True)
    mesh = Mesh(SHARD_MESH, ("data", "model"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with recording("flash_attention") as calls:
        params, opt, losses, tel = train(cfg, run, SHARD_STEPS, device=DEV,
                                         mesh=mesh, log_every=1)
    torch.cuda.synchronize()
    counts, routes = ops.launch_counts(), ops.route_counts()["flash_attention"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = cfg.n_layers * SHARD_STEPS * mesh.size
    check(counts["flash_attention"] == want and
          routes == {"wgmma": want, "mma": 0},
          f"lm_shard: flash_attention launched {counts['flash_attention']} "
          f"times by route {routes}, not {want} on wgmma")
    gaps = [abs(a - b) for a, b in zip(losses, one["losses"])]
    log(f"[lm_shard] {cfg.name} on {mesh.shape} with FSDP: losses {losses}; "
        f"one device (lm_train) {one['losses'][:SHARD_STEPS]}; gaps "
        f"{[f'{x:.2e}' for x in gaps]} (tol {LM_LOSS_TOL} nats)")
    check(all(np.isfinite(losses)) and max(gaps) <= LM_LOSS_TOL,
          f"lm_shard: losses {losses} not within {LM_LOSS_TOL} of one "
          f"device's {one['losses']}")
    step_ms = tel.summary()["mean_s"] * 1e3
    payload = {k: v / SHARD_STEPS for k, v in mesh.group.payload.items()}
    log(f"[lm_shard] {step_ms:.2f} ms a step (mean of steps 1-"
        f"{SHARD_STEPS - 1}; one device {one['step_ms']:.2f}), "
        f"{LM_BATCH * LM_SEQ / step_ms * 1e3:.4e} tokens/s; peak memory "
        f"{peak_gb:.2f} GB (one device {one['peak_memory_gb']:.2f}); the "
        f"group's payload a step {sum(payload.values()) / 1e9:.3f} GB: "
        + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in payload.items()))
    del params, opt
    torch.cuda.empty_cache()
    (a, _, _), = calls.values()
    q, k, v = (t.detach() for t in a)
    bh, s, dh = q.shape
    check(bh == LM_BH // mesh.size and fa.route(q, k, v) == "wgmma",
          f"lm_shard: the shard's flash shape {tuple(q.shape)} is not "
          f"({LM_BH // mesh.size}, {LM_SEQ}, {cfg.head_dim_}) on wgmma")
    err = compare("flash_attention", f"shard {tuple(q.shape)} wgmma",
                  fa.launch(q, k, v, True), ref.flash_attention(q, k, v),
                  FLASH_BF16_TOL)
    t_k = time_ms(lambda: fa.launch(q, k, v, True), reps=20)
    t_m = time_ms(lambda: fa.launch(q, k, v, True, route="mma"), reps=20)
    t_p = time_ms(lambda: ref.flash_attention(q, k, v), reps=5)
    b_row = LM_BATCH // mesh.n_data
    q4, k4, v4 = (t.view(b_row, bh // b_row, s, dh) for t in (q, k, v))
    t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), reps=20)
    flops, (bms, by) = flash_bound(q, k, v)
    log(f"[times] flash_attention at the shard's shape ({bh}, {s}, {dh}) bf16 "
        f"causal: wgmma {t_k:.4f} ms ({flops / t_k / 1e9:.1f} TFLOP/s, "
        f"{bms / t_k:.3f} of the bound), mma {t_m:.4f}, plain {t_p:.4f}, SDPA "
        f"{t_l:.4f}, bound {bms:.4f} ms ({by})")
    report["lm_shard"]["olmo"] = dict(
        mesh=list(SHARD_MESH), losses=losses, one_device=one["losses"],
        gaps=gaps, step_ms=step_ms, one_device_step_ms=one["step_ms"],
        step_times_s=tel.times, peak_memory_gb=peak_gb, payload=payload,
        launches=counts["flash_attention"], flash_shape=[bh, s, dh],
        flash_ms=t_k, mma_ms=t_m, plain_ms=t_p, library_ms=t_l, bound_ms=bms,
        bound_by=by, err=err)
    del q, k, v, q4, k4, v4, a, calls
    torch.cuda.empty_cache()
    entry = kernel_entry(
        "lm_shard", "flash_attention", "cuda",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:106", counts["flash_attention"],
        err, t_k, t_p, bms, by, t_l)
    entry.update(variant="wgmma", mma_ms=t_m)
    return entry


def shard_elastic(report):
    """olmo-1b at SHARD_CKPT_LAYERS layers on SHARD_MESH with FSDP:
    SHARD_CKPT_STEPS steps checkpointed (the tree gathered whole), the
    restored tree bitwise the shards' slices gathered, and the next step on
    (2, 2) against the same step resumed from the checkpoint on
    ``factor_mesh(2, want_model=2)`` (``train(checkpoint_dir=)``) and on
    one device (the restored state, as ``train`` restores it), within
    LM_LOSS_TOL."""
    import dataclasses
    import tempfile
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch.elastic import factor_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import (batch_to, build_train_step,
                                          place_batch)
    from repro_torch.launch.train import restore_state, train
    from repro_torch.models.parallel import gather_leaves
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=SHARD_CKPT_LAYERS)
    run = RunConfig(seq_len=LM_SEQ, global_batch=LM_BATCH, flash_kernel=True,
                    fsdp=True)
    mesh = Mesh(SHARD_MESH, ("data", "model"))
    nxt = SHARD_CKPT_STEPS
    with tempfile.TemporaryDirectory(prefix="lm_shard-") as ck:
        t0 = time.perf_counter()
        params, opt, first, _ = train(
            cfg, run, SHARD_CKPT_STEPS, device=DEV, mesh=mesh,
            checkpoint_dir=ck, checkpoint_every=SHARD_CKPT_STEPS, log_every=0)
        saved_s = time.perf_counter() - t0
        built = build_train_step(cfg, run, DEV, mesh=mesh)
        batch = TokenStream(vocab=cfg.vocab, seq_len=LM_SEQ, batch=LM_BATCH,
                            seed=run.seed).batch_at(nxt)
        whole = gather_leaves(params.layout, params.shards)
        nu = gather_leaves(params.layout, opt["nu"])
        _, _, m = built["fn"](params, opt, place_batch(
            batch, mesh, built["rules"], DEV), nxt)
        on_22 = float(m["loss"])
        del params, opt
        # one device resumes as train does: restore_state, then the step
        module, ropt, step = restore_state(cfg, CheckpointStore(ck), DEV)
        same = step == nxt and ropt["count"] == nxt and all(
            torch.equal(a, b) for a, b in zip(module.parameters(), whole)) \
            and all(torch.equal(a, b) for a, b in zip(ropt["nu"], nu))
        check(same, "lm_shard: the checkpoint restored is not bitwise the "
                    "shards' slices gathered")
        del whole, nu
        one = build_train_step(cfg, run, DEV)
        resumed = {"one device": float(one["fn"](
            module, ropt, batch_to(batch, DEV), nxt)[2]["loss"])}
        del module, ropt, one
        torch.cuda.empty_cache()
        resumed["(1, 2)"] = train(cfg, run, 1, device=DEV,
                                  mesh=factor_mesh(2, want_model=2),
                                  checkpoint_dir=ck, log_every=0)[2][0]
        total_s = time.perf_counter() - t0
    gaps = {k: abs(v - on_22) for k, v in resumed.items()}
    log(f"[lm_shard] elastic: {cfg.name} at {cfg.n_layers} layers on "
        f"{mesh.shape}: losses {first}, checkpoint at step {nxt} restored "
        f"bitwise the slices gathered; step {nxt} on (2, 2) {on_22:.6f}, "
        f"resumed " + ", ".join(f"on {k} {v:.6f} (gap {gaps[k]:.2e})"
                                for k, v in resumed.items())
        + f" (tol {LM_LOSS_TOL}); {saved_s:.1f} s to the checkpoint, "
        f"{total_s:.1f} s in all")
    check(all(g <= LM_LOSS_TOL for g in gaps.values()),
          f"lm_shard: resumed losses {resumed} not within {LM_LOSS_TOL} of "
          f"the (2, 2) run's {on_22}")
    report["lm_shard"]["elastic"] = dict(
        losses=first, next_loss=on_22, resumed=resumed, gaps=gaps,
        restored_bitwise=same, seconds=total_s)


def shard_moe(report, one):
    """qwen3-moe at lm_moe's training settings on SHARD_MOE_MESH (the
    experts split over the model shards): SHARD_MOE_STEPS steps, each loss
    within LM_LOSS_TOL of lm_moe's one-device plain run."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import train
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
    run = RunConfig(seq_len=MOE_SEQ, global_batch=MOE_BATCH, warmup=1,
                    flash_kernel=True)
    mesh = Mesh(SHARD_MOE_MESH, ("data", "model"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, tel = train(cfg, run, SHARD_MOE_STEPS, device=DEV,
                                     mesh=mesh, log_every=0)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layout = params.layout
    del params, opt
    torch.cuda.empty_cache()
    gaps = [abs(a - b) for a, b in zip(losses, one["losses"])]
    step_ms = float(np.mean(tel.times[1:] or tel.times)) * 1e3
    log(f"[lm_shard] experts: {cfg.name} at {cfg.n_layers} layers on "
        f"{mesh.shape} ({cfg.n_experts // mesh.n_model} experts a shard, "
        f"split: attention {layout.attn}, experts {layout.moe}, vocabulary "
        f"{layout.vocab}): losses {losses}, one device {one['losses'][:2]}, "
        f"gaps {[f'{x:.2e}' for x in gaps]} (tol {LM_LOSS_TOL}); "
        f"{step_ms:.2f} ms a step (one device {one['step_ms']:.2f}), peak "
        f"memory {peak_gb:.2f} GB")
    check(layout.moe and all(np.isfinite(losses))
          and max(gaps) <= LM_LOSS_TOL,
          f"lm_shard: qwen3-moe on {mesh.shape}: losses {losses} not within "
          f"{LM_LOSS_TOL} of {one['losses']}")
    report["lm_shard"]["moe"] = dict(losses=losses, gaps=gaps,
                                     step_ms=step_ms, peak_memory_gb=peak_gb)


def shard_two_processes(report):
    """Two gloo ranks on the card (the ``lda_multihost`` pattern), each
    running one shard of (1, 2) at olmo-1b's full width and
    SHARD_MP_LAYERS layers: SHARD_MP_STEPS steps bitwise this process
    running both shards (one digest of every leaf and the losses); each
    rank's wire bytes and seconds a step."""
    import socket
    torch.cuda.empty_cache()
    one = shard_mp_run()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_MP_CHILD.format(
            src=str(ROOT / "src"), root=str(ROOT), port=port, rank=r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    got = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        check(p.returncode == 0 and "DONE" in out,
              f"lm_shard: gloo rank failed ({p.returncode}):\n{err[-3000:]}")
        line = [x for x in out.splitlines() if x.startswith("RESULT")][0]
        digest, wire, secs, ms = line.split()[1:]
        got.append(dict(digest=digest, wire=int(wire), seconds=float(secs),
                        step_ms=float(ms)))
    same = all(g["digest"] == one["digest"] for g in got)
    n = SHARD_MP_STEPS
    wire = ", ".join(f"{g['wire'] / n / 1e9:.3f}" for g in got)
    secs = ", ".join(f"{g['seconds'] / n:.3f}" for g in got)
    ms = ", ".join(f"{g['step_ms']:.1f}" for g in got)
    log(f"[lm_shard] two gloo processes on one card, (1, 2) at "
        f"{SHARD_MP_LAYERS} layers: digests "
        f"{[g['digest'][:16] for g in got]} against one process's "
        f"{one['digest'][:16]} ({'bitwise' if same else 'DIFFERENT'}); per "
        f"rank a step: wire [{wire}] GB, exchange seconds [{secs}], "
        f"[{ms}] ms a step (one process {one['step_ms']:.1f} ms, payload "
        f"{one['payload'] / n / 1e9:.3f} GB a step)")
    check(same, "lm_shard: two gloo processes are not bitwise one")
    report["lm_shard"]["two_processes"] = dict(one=one, ranks=got,
                                               bitwise=same)


def shard_serve(report):
    """olmo-1b at full width and depth served in f32 through
    ``serve(mesh=)`` for each of SHARD_SERVE_CASES: the greedy tokens equal
    one device's ``serve`` from the same parameters; the cache's placement,
    prefill and decode times beside one device's.  Then whisper-large-v3
    and internvl2-1b for each of SHARD_MODAL_CASES (:func:`modal_serve`)."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.shardings import Rules
    from repro_torch.models import make_model
    cfg = get_arch(LM_ARCH)
    out = {}
    for b, shape in SHARD_SERVE_CASES:
        run = RunConfig(seq_len=SHARD_SERVE_PROMPT, global_batch=b,
                        dtype="float32")
        torch.cuda.empty_cache()
        params = make_model(cfg)["init"](run, device=DEV)
        prompts = np.random.default_rng(70 + b).integers(
            0, cfg.vocab, (b, SHARD_SERVE_PROMPT))
        want, one = serve(cfg, run, prompts, SHARD_SERVE_NEW, device=DEV,
                          params=params)
        mesh = Mesh(shape, ("data", "model"))
        torch.cuda.reset_peak_memory_stats()
        got, st = serve(cfg, run, prompts, SHARD_SERVE_NEW, device=DEV,
                        params=params, mesh=mesh)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del params
        same = bool(np.array_equal(got, want))
        spec = Rules(cfg, run, mesh).cache_leaf("k", (
            b, SHARD_SERVE_PROMPT + SHARD_SERVE_NEW, cfg.n_kv_heads,
            cfg.head_dim_))
        log(f"[lm_shard] serve {cfg.name} f32, {b} x {SHARD_SERVE_PROMPT} + "
            f"{SHARD_SERVE_NEW} on {mesh.shape}: K/V placed {spec} over (B, "
            f"S, KV, Dh); greedy tokens {'equal' if same else 'DIFFER from'}"
            f" one device's; prefill {st['prefill_s'] * 1e3:.1f} ms (one "
            f"device {one['prefill_s'] * 1e3:.1f}), decode "
            f"{st['decode_s'] / SHARD_SERVE_NEW * 1e3:.2f} ms a step (one "
            f"device {one['decode_s'] / SHARD_SERVE_NEW * 1e3:.2f}), "
            f"{st['tokens_per_s']:.1f} tokens/s, peak memory {peak_gb:.2f} "
            f"GB")
        check(same, f"lm_shard: serve on {mesh.shape} gives other tokens "
                    f"than one device")
        out[f"{b} on {shape}"] = dict(
            spec=spec, tokens_equal=same, stats=st, one_device=one,
            peak_memory_gb=peak_gb)
    del want, got
    for name, b, shape in SHARD_MODAL_CASES:
        out[f"{name} {b} on {shape}"] = modal_serve(name, b, shape)
    report["lm_shard"]["serve"] = out


def modal_greedy(cfg, run, params, batch, cache_len, start, mesh=None):
    """A timed prefill of ``batch`` into a cache of ``cache_len`` positions
    and SHARD_MODAL_NEW greedy decode steps from position ``start``, on one
    device or ``mesh`` (``params`` placed there first): the tokens, every
    step's logits, the ms and, on a mesh, the cache's first layer's specs,
    the prefill's payload by key and the step functions."""
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models.parallel import ShardedParams
    pre = build_prefill_step(cfg, run, DEV, mesh=mesh)
    dec = build_decode_step(cfg, run, DEV, mesh=mesh)
    if mesh is not None:
        params = ShardedParams.from_module(pre["server"].layout, params)
    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = pre["fn"](params, batch, cache_len)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        if mesh is not None:
            out["prefill_payload"] = dict(mesh.group.payload)
            out["prefill_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            out["specs"] = cache.specs[0]
        logits, toks = [lg], []
        t0 = time.perf_counter()
        for i in range(SHARD_MODAL_NEW):
            toks.append(lg.argmax(-1))
            lg, cache = dec["fn"](params, cache, toks[-1][:, None], start + i)
            logits.append(lg)
        torch.cuda.synchronize()
        out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / SHARD_MODAL_NEW
        del cache
    return dict(out, tokens=torch.stack(toks, 1).cpu().numpy(),
                logits=logits, params=params, prefill=pre["fn"])


def modal_serve(name, b, shape):
    """``name`` at full width and depth in f32 on ``shape`` against one
    device from the same parameters: the greedy tokens equal; the prefill
    with the frames or patches zeroed moves the logits by more than
    SHARD_MODAL_POWER times the largest logit gap between the two; the self
    and cross K/V placements, that gap, prefill and decode ms against one
    device's and the peak memory logged."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import batch_to
    from repro_torch.models import make_model
    cfg = get_arch(name)
    if cfg.family == "encdec":
        text, prefix, key = len(ENC_SOT), 0, "frames"
        nb = encoder_batch(cfg, b, text, SEED + 80 + b, tokens=np.tile(
            np.asarray(ENC_SOT, np.int32), (b, 1)))
    else:
        text, prefix, key = SHARD_MODAL_TEXT, cfg.n_patches, "patches"
        nb = encoder_batch(cfg, b, text, SEED + 80 + b)
        del nb["labels"]
    run = RunConfig(seq_len=text, global_batch=b, dtype="float32")
    torch.cuda.empty_cache()
    params = make_model(cfg)["init"](run, device=DEV)
    batch = batch_to(nb, DEV)
    cache_len, start = prefix + text + SHARD_MODAL_NEW, prefix + text
    one = modal_greedy(cfg, run, params, batch, cache_len, start)
    mesh = Mesh(shape, ("data", "model"))
    one_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    got = modal_greedy(cfg, run, params, batch, cache_len, start, mesh)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    same = bool(np.array_equal(got["tokens"], one["tokens"]))
    v = cfg.vocab
    gap = max(float((a[:, :v] - w[:, :v]).abs().max())
              for a, w in zip(got["logits"], one["logits"]))
    with torch.inference_mode():
        zeroed = got["prefill"](got["params"], dict(
            batch, **{key: torch.zeros_like(batch[key])}), cache_len)[0]
    moved = float((zeroed[:, :v] - one["logits"][0][:, :v]).abs().max())
    specs = got["specs"]
    cross = specs.get("cross", {}).get("k")
    log(f"[lm_shard] serve {name} f32, {b} x ({prefix} + {text}) + "
        f"{SHARD_MODAL_NEW}" + (f" against {ENC_FRAMES} frames" if
                                key == "frames" else "")
        + f" on {mesh.shape}: self K/V placed {specs['k']}"
        + (f", cross K/V {cross}" if cross else "")
        + f" over (B, KV, S, Dh); greedy tokens "
        f"{'equal' if same else 'DIFFER from'} one device's; largest logit "
        f"gap {gap:.3e}; {key} zeroed move the prefill's logits {moved:.3e} "
        f"({moved / max(gap, 1e-30):.3g}x the gap); prefill "
        f"{got['prefill_ms']:.1f} ms (one device {one['prefill_ms']:.1f}), "
        f"decode {got['decode_ms']:.2f} ms a step (one device "
        f"{one['decode_ms']:.2f}); peak memory {peak_gb:.2f} GB ("
        f"{one_gb:.2f} GB held before the mesh's steps)")
    check(same, f"lm_shard: {name} on {mesh.shape} gives other tokens than "
                f"one device")
    check(moved > SHARD_MODAL_POWER * gap and moved > 0, f"lm_shard: {name} "
          f"on {mesh.shape} with its {key} zeroed moves the logits {moved:.3e},"
          f" not {SHARD_MODAL_POWER}x the mesh's gap {gap:.3e}")
    res = dict(self_spec=specs["k"], cross_spec=cross, tokens_equal=same,
               logit_gap=gap, zeroed_moved=moved,
               prefill_ms=got["prefill_ms"], decode_ms=got["decode_ms"],
               one_device=dict(prefill_ms=one["prefill_ms"],
                               decode_ms=one["decode_ms"]),
               prefill_payload=got["prefill_payload"],
               prefill_peak_gb=got["prefill_peak_gb"], held_gb=one_gb,
               peak_memory_gb=peak_gb)
    del params, one, got, zeroed, batch
    torch.cuda.empty_cache()
    return res


def phase_lm_shard(report):
    """LM sharding on the card: olmo-1b at full width and depth on a
    (2, 2) mesh with FSDP against lm_train's one device (entry
    ``lm_shard``), the elastic re-mesh from a checkpoint, qwen3-moe's
    experts split over (1, 2) against lm_moe's one device, two gloo
    processes bitwise one, and serving on (1, 2) and (2, 1) against one
    device's tokens, whisper-large-v3 and internvl2-1b too."""
    report["lm_shard"] = {}
    stage_s = report["lm_shard"]["stage_s"] = {}

    def timed(key, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        stage_s[key] = time.perf_counter() - t0
        return out
    entry = timed("olmo", shard_olmo, report, report["lm_train"])
    timed("elastic", shard_elastic, report)
    timed("moe", shard_moe, report, report["lm_moe"]["train"]["runs"]["plain"])
    timed("two processes", shard_two_processes, report)
    timed("serve", shard_serve, report)
    log(f"[lm_shard] seconds by stage: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in stage_s.items())}")
    return [entry]


# ---------------------------------------------------------------------------
# the dry run: steps counted on meta tensors, held to the readings above
# ---------------------------------------------------------------------------

# the counted peak against max_memory_allocated: both readings so far were
# within 0.6% (PERF.md), so a storage the count stops seeing fails here
PEAK_TOL = 0.02


def costs_line(label, costs, measured_ms, dev_line):
    """Log a counted step beside its measured ms; returns its numbers."""
    from repro_torch.launch import roofline as RL
    d = costs.as_dict()
    roof = RL.roofline({"flops": d["flops"], "bytes accessed":
                        d["traffic_bytes"]},
                       {"total_bytes": d["collective_bytes"]}, 1)
    roof_ms = max(roof[k] for k in ("compute_s", "memory_s",
                                    "collective_s")) * 1e3
    log(f"[costs] {label}: counted {d['flops']:.4e} FLOPs, "
        f"{d['traffic_bytes']:.4e} bytes, collective {d['collective_bytes']:.4e}"
        f" bytes; roofline {roof_ms:.4f} ms ({roof['bottleneck']}); measured "
        f"{measured_ms:.4f} ms, {measured_ms / roof_ms:.2f}x the roofline; "
        f"peak {d['peak_bytes'] / 1e9:.3f} GB; traced in {costs.seconds:.2f} "
        f"s; {dev_line}")
    return dict(d, roofline_ms=roof_ms, measured_ms=measured_ms,
                ratio=measured_ms / roof_ms, bottleneck=roof["bottleneck"],
                trace_s=costs.seconds)


def phase_costs(report, prog, steps):
    """The dry run (``launch.step_cost.count``: each step traced once on
    ``meta`` tensors, nothing launched on the card) of steps earlier phases
    measured, held to their readings: the main path's VMP step (its
    launches by kernel and route times ``steps`` equal to the launches of
    ``phase_main``'s ``infer``), ``lda_dist``'s 2-shard step (the payload
    by key equal to one measured step's), ``lm_train``'s olmo-1b step (flash
    launches times LM_STEPS equal to its launches, all ``wgmma``; peak
    bytes within PEAK_TOL of its ``max_memory_allocated``) and
    ``lm_shard``'s (2, 2) FSDP step with every shard in one process, as
    measured (payload by key equal to a measured step's, flash launches,
    peak within PEAK_TOL) and whisper's (2, 2) prefill of ``lm_shard``'s
    serve stage, every shard in one process (payload by key equal to the
    measured prefill's, the counted peak logged beside its
    ``max_memory_allocated``); each with its counted FLOPs and bytes, the
    roofline's ms, the measured ms and their ratio.  The dry run's fit
    limit, ``launch.roofline.HBM_BYTES``, must not exceed the memory the
    allocator sees on this card."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.core import runtime, vmp
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.dryrun import train_costs, vmp_step
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.step_cost import count
    dev_line = device_line()
    out = report["costs"] = {}

    total = torch.cuda.get_device_properties(0).total_memory
    smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.total",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[costs] device memory: total_memory {total} bytes, nvidia-smi "
        f"memory.total {smi}; the dry run's fit limit HBM_BYTES "
        f"{RL.HBM_BYTES}; {dev_line}")
    check(RL.HBM_BYTES <= total,
          f"costs: HBM_BYTES {RL.HBM_BYTES} is more than the card's "
          f"{total} bytes")
    out["memory"] = dict(total_memory=total, smi_total=smi,
                         hbm_bytes=RL.HBM_BYTES)

    def launches(costs, times):
        return {k: v["count"] * times for k, v in costs.launches.items()}

    def routes(costs, name, times):
        row = costs.launches.get(name, {"routes": {}})["routes"]
        return {k: v * times for k, v in row.items()}

    state = vmp.init_state(prog, SEED, device="meta")
    main = count(runtime.make_step(prog, device="meta"), state)
    got, want = launches(main, steps), report["infer_launches"]
    check(got == {k: v for k, v in want.items() if v} and
          routes(main, "zstats", steps) ==
          {k: v for k, v in report["routes"]["zstats"].items() if v},
          f"costs: the main path's counted launches {got}, "
          f"{main.launches} a step, are not infer's {want}, "
          f"{report['routes']}")
    out["main"] = costs_line("main VMP step", main, report["step_ms"],
                             dev_line)

    step, st = vmp_step(prog, DIST_SHARDS)
    dist = count(step, st, group=step.plan.group)
    moved = report["lda_dist"]["vmp"]["payload_per_step"][0]
    check(step.plan.group.payload == moved,
          f"costs: lda_dist's counted payload {step.plan.group.payload} is "
          f"not the measured {moved}")
    out["lda_dist"] = costs_line(
        f"lda_dist VMP step ({DIST_SHARDS} shards; payload {moved} bytes, "
        f"as measured)", dist, report["lda_dist"]["vmp"]["step_ms"][0],
        dev_line)
    del step, st, dist, main, state

    cfg = get_arch(LM_ARCH)
    run = RunConfig(seq_len=LM_SEQ, global_batch=LM_BATCH, flash_kernel=True)
    seen = report["lm_train"]
    out["lm_train"] = lm_costs("lm_train", train_costs(cfg, run), seen,
                               seen["launches"]["flash_attention"],
                               LM_STEPS, dev_line)
    seen = report["lm_shard"]["olmo"]
    mesh = Mesh(SHARD_MESH, ("data", "model"))     # every shard here, as run
    costs = train_costs(cfg, dataclasses.replace(run, fsdp=True), mesh)
    pay = {k: round(v) for k, v in seen["payload"].items()}
    check(mesh.group.payload == pay,
          f"costs: lm_shard's counted payload {mesh.group.payload} is not a "
          f"measured step's {pay}")
    out["lm_shard"] = lm_costs("lm_shard", costs, seen, seen["launches"],
                               SHARD_STEPS, dev_line)
    out["lm_shard_whisper"] = whisper_prefill_costs(report, dev_line)


def whisper_prefill_costs(report, dev_line):
    """The (2, 2) prefill of ``modal_serve``'s whisper case counted on
    ``meta`` at its shapes, every shard in one process as measured: the
    payload by key must equal the measured prefill's; the counted peak
    beside that prefill's ``max_memory_allocated``."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.step_cost import count
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import make_model
    from repro_torch.models.parallel import ShardedParams
    name, b, shape = SHARD_MODAL_CASES[0]
    seen = report["lm_shard"]["serve"][f"{name} {b} on {shape}"]
    cfg = get_arch(name)
    text = len(ENC_SOT)
    run = RunConfig(seq_len=text, global_batch=b, dtype="float32")
    mesh = Mesh(shape, ("data", "model"))
    built = build_prefill_step(cfg, run, "meta", mesh=mesh)
    params = ShardedParams.from_module(built["server"].layout, make_model(
        cfg)["init"](run, device="meta"))
    batch = {"tokens": torch.empty((b, text), dtype=torch.int64,
                                   device="meta"),
             "frames": torch.empty((b, ENC_FRAMES, cfg.d_model),
                                   device="meta")}
    costs = count(built["fn"], params, batch, text + SHARD_MODAL_NEW,
                  group=mesh.group)
    want = seen["prefill_payload"]
    check(mesh.group.payload == want,
          f"costs: whisper's counted prefill payload {mesh.group.payload} "
          f"on {shape} is not the measured {want}")
    peak = costs.peak_bytes / 1e9
    log(f"[costs] whisper prefill on {shape}: payload by key equal to the "
        f"measured prefill's ({sum(want.values())} bytes, "
        f"{len(want)} keys); counted peak {peak:.3f} GB beside "
        f"max_memory_allocated {seen['prefill_peak_gb']:.3f} GB, which "
        f"also holds the one-device parameters' {seen['held_gb']:.3f} GB")
    return dict(costs_line(f"whisper prefill on {shape}", costs,
                           seen["prefill_ms"], dev_line),
                peak_memory_gb=seen["prefill_peak_gb"])


def lm_costs(label, costs, seen, launches, times, dev_line):
    """An LM step's counted flash launches (times ``times`` steps) against
    the ``launches`` its phase measured, all on ``wgmma``, and its counted
    peak against the phase's ``max_memory_allocated``; its costs line."""
    flash = costs.launches["flash_attention"]
    check(flash["count"] * times == launches and
          flash["routes"] == {"wgmma": flash["count"]},
          f"costs: {label}'s counted flash launches {flash} times {times} "
          f"are not the {launches} measured")
    peak, measured = costs.peak_bytes / 1e9, seen["peak_memory_gb"]
    log(f"[costs] {label}: counted peak {peak:.3f} GB against "
        f"max_memory_allocated {measured:.3f} GB ({peak / measured - 1:+.2%},"
        f" tol {PEAK_TOL:.0%}); flash {flash['count']} launches a step, "
        f"{flash['routes']}")
    check(abs(peak / measured - 1) <= PEAK_TOL,
          f"costs: {label}'s counted peak {peak:.3f} GB is not within "
          f"{PEAK_TOL:.0%} of the measured {measured:.3f} GB")
    return dict(costs_line(f"{label} step", costs, seen["step_ms"],
                           dev_line), peak_memory_gb=measured)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--docs", type=int, default=30000,
                   help="documents of the main path's corpus (depth)")
    p.add_argument("--steps", type=int, default=10,
                   help="VMP steps of the main path")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    dev_line = device_line()
    log(f"[device] {dev_line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    report = {"device": dev_line, "args": vars(args)}
    phase_s = report["phase_s"] = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t0
        return out

    phase_build(report)
    phase_kernels_vs_plain(report)
    report["zmap_edge_max_abs"] = phase_zmap_kernels()
    corpus, m, prog = make_main_model(args)
    counts = phase_main(args, report, corpus, m, prog)
    kernels = phase_repeat_and_time(args, report, m, prog, counts)
    entries, svi_state, svi_holdout, svi_held = timed(
        "lda_svi", phase_lda_svi, report, prog, m)
    kernels += entries
    entries, post = timed("query", phase_query, report, m, prog, svi_state,
                          svi_holdout, corpus, svi_held)
    kernels += entries
    kernels += timed("gateway", phase_gateway, report, post, corpus)
    del post
    kernels += timed("lda_ooc", phase_lda_ooc, report, corpus, prog)
    kernels += timed("gibbs", phase_gibbs, report, m, prog, corpus,
                     svi_state, svi_held, len(svi_holdout))
    kernels += timed("lda_dist", phase_lda_dist, report, corpus, prog)
    del m, svi_state
    prog.meta.pop("_zstats_plan", None)       # the card's plans; costs
    # counts the program's step again on meta
    payloads = slda_payloads(corpus)
    slda = make_slda(corpus)
    del corpus
    counts = phase_segment("slda", slda, args.steps, "z", report)
    kernels += phase_segment_times("slda", slda, report, counts)
    entries, slda_state = timed("slda_svi", phase_segment_svi, "slda", slda,
                                report, bitwise_vmp=False)
    kernels += entries
    kernels += timed("slda_query", phase_slda_query, report, slda,
                     slda_state, payloads)
    del slda, slda_state
    nb = make_naive_bayes(args)
    counts = phase_segment("naive_bayes", nb, NB_STEPS, "c", report)
    kernels += phase_segment_times("naive_bayes", nb, report, counts)
    kernels += timed("naive_bayes_svi", phase_segment_svi, "naive_bayes",
                     nb, report, bitwise_vmp=True)[0]
    del nb
    kernels += timed("dcmlda", phase_dcmlda, report)
    kernels += timed("dcmslda", phase_dcmslda, report)
    kernels += timed("dirichlet_terms", phase_dirichlet_terms, report)
    kernels += phase_lm_train(report, phase_flash(report))
    kernels += timed("lm_serve", phase_lm_serve, report)
    kernels += timed("lm_moe", phase_lm_moe, report)
    kernels += timed("lm_recurrent", phase_lm_recurrent, report)
    kernels += timed("lm_encoder", phase_lm_encoder, report)
    kernels += timed("lm_shard", phase_lm_shard, report)
    timed("costs", phase_costs, report, prog, args.steps)
    report["seconds"] = time.perf_counter() - t_start
    REPORT.parent.mkdir(parents=True, exist_ok=True)
    REPORT.write_text(json.dumps(report, indent=1, default=float))
    log(f"[done] {report['seconds']:.1f} s (kernel builds "
        f"{report['build_s']:.1f} s; timed phases "
        f"{sum(phase_s.values()):.1f} s: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in phase_s.items())}); report "
        f"in {REPORT}")
    print(dev_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
